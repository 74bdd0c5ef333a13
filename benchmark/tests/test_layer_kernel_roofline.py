"""`metrics/layer_kernel_roofline.py`: the fused layer's kernels read by
name from the device trace, on synthetic traces (every call eager; a
graph whose capture recorded each call once and whose replays ran them
again; nothing to read) and, on the card (marked `cuda`; skipped without
one), over the traced epochs of a 64-env thin-goal cell whose update
replays a CUDA graph."""
import numpy as np
import pytest

from harness import costs
from harness.trace import WINDOW_SPAN, Interval, Trace

FWD = "void transformer_layer_kernel<2, 4>(LayerArgs, TlPlan)"
BWD = "transformer_layer_bwd_kernel(BwdArgs)"
INF, GRAD = (1024, 17, 256, False), (1024, 17, 256, True)


class _Ctx:
  def __init__(self, trace, calls):
    self.trace, self.calls = trace, calls


def _trace(names, us=10):
  """Ops of `us` microseconds each, back to back, named `names`."""
  ops = [Interval(n, 1000 * us * i, 1000 * us * (i + 1))
         for i, n in enumerate(names)]
  return Trace([Interval(WINDOW_SPAN, 0, 10 ** 12, 0)], ops,
               np.zeros(len(ops), np.int64))


def _least(n_inf, n_grad):
  from metrics import layer_kernel_roofline as m
  return (n_inf * costs.layer_least_s(*INF[:2], m.D, INF[2], False)
          + n_grad * m.kernel_grad_least_s(*GRAD[:2], m.D, GRAD[2]))


@pytest.mark.parametrize("calls,n_inf,n_grad", [
    ([INF] * 6 + [GRAD] * 4, 6, 4),      # eager: a kernel a recorded call
    ([INF] * 6 + [GRAD] * 4, 6, 192),    # a capture of 4, 48 replays
])
def test_kernels_by_name_times_the_recorded_shapes(calls, n_inf, n_grad):
  """Each backward kernel is one recorded gradient call's work, each
  forward kernel beyond them one inference call's; other ops (a cuBLAS
  product of the weight gradients) are neither timed nor counted."""
  from metrics import layer_kernel_roofline as m
  names = ([FWD] * (n_inf + n_grad) + [BWD] * n_grad
           + ["ampere_sgemm_32x32_sliced1x4_tn"] * 5)
  got = m.read(_Ctx(_trace(names), {"layer": calls}))
  dev_s = (n_inf + 2 * n_grad) * 10e-6
  assert got == pytest.approx(100.0 * _least(n_inf, n_grad) / dev_s)


def test_the_pair_leaves_out_the_weight_gradients():
  """A kernel pair does less than `layer_grad_cost`: the weight
  gradients' products are torch's, after the backward kernel."""
  from metrics import layer_kernel_roofline as m
  B, T, F = 1024, 17, 256
  full = costs.layer_least_s(B, T, m.D, F, True)
  fwd = costs.layer_least_s(B, T, m.D, F, False)
  assert fwd < m.kernel_grad_least_s(B, T, m.D, F) < full


@pytest.mark.parametrize("calls,names", [
    (None, [FWD]),
    ({"layer": []}, [FWD]),
    ({"layer": [INF]}, ["ampere_sgemm"]),         # no kernel ran
    ({"layer": [GRAD]}, [FWD, BWD, BWD]),         # more backwards
    ({"layer": [INF]}, [FWD, BWD]),               # no gradient call seen
])
def test_none_where_nothing_fits(calls, names):
  from metrics import layer_kernel_roofline as m
  assert m.read(_Ctx(_trace(names), calls)) is None
  assert m.read(_Ctx(None, calls)) is None


@pytest.mark.cuda
def test_replayed_kernels_are_read_on_the_card(card, tmp_path):
  """Two traced epochs at 64 envs: every minibatch's four layer calls run
  as kernels (one capture an epoch records them, the replays run them
  again), every collection call runs one forward, and the share lies in
  (0, 100]."""
  from conftest import tiny_root
  from harness import cell as cell_lib, check, run_cell
  from metrics import layer_kernel_roofline as m
  from test_harness_card import CARD
  root = str(tmp_path)
  tiny_root(root, "thin-goal.train", CARD)
  cell = cell_lib.load("thin-goal.tiny", root)
  cell_lib.precision(cell.params)
  agent, _ = check.warm_start(cell, 2 ** 31 + 23, card)
  cfg = agent.learner.cfg
  n_mb = cfg.opt_epochs * cfg.epoch_frames // cfg.batch_size
  trace, calls = run_cell.traced(agent, run_cell.TRACED_EPOCHS)
  names = [o.name for o in trace.ops]
  n_bwd = sum(m.BACKWARD in n for n in names)
  n_fwd = sum(m.FORWARD in n for n in names)
  grad = [c for c in calls["layer"] if c[3]]
  inf = [c for c in calls["layer"] if not c[3]]
  assert n_bwd == 4 * n_mb * run_cell.TRACED_EPOCHS
  assert len(grad) == 4 * run_cell.TRACED_EPOCHS      # the captures
  assert n_fwd - n_bwd == len(inf) > 0
  got = m.read(_Ctx(trace, calls))
  print(f"layer_kernel_roofline {got} on {n_fwd} forward and {n_bwd} "
        f"backward kernels")
  assert 0 < got <= 100
