"""The layer's end-to-end gradient gate (`attention.compare_grads_with_plain`)
at its ReLU kinks, on the CPU.

A forward that puts an FFN pre-activation within float32's reach of zero
on the other side of the ReLU than the float64 plain layer moves that
sample's gradients by O(0.1-1).  The gate decides such a flip by the
plain gradient recomputed under the forward's own mask; an error away
from a kink, or a flip beyond float32's reach, stays refused.  The
flips are injected: `run` and `saved` are the plain layer under a fixed
ReLU mask, the float64 plain mask with chosen entries turned over.
"""
import numpy as np
import torch

from vision4leg_torch.ops import attention as att

B, T, D, F = 8, 17, 64, 256


def _case(seed=0):
  rng = np.random.default_rng(seed)
  t = lambda *s, scale=1.0: torch.tensor(
      rng.normal(0.0, scale, s).astype(np.float32))
  w = att.LayerWeights(
      wq=t(D, D, scale=D ** -0.5), bq=t(D, scale=0.1),
      wk=t(D, D, scale=D ** -0.5), bk=t(D, scale=0.1),
      wv=t(D, D, scale=D ** -0.5), bv=t(D, scale=0.1),
      wo=t(D, D, scale=D ** -0.5), bo=t(D, scale=0.1),
      ln1_scale=1 + t(D, scale=0.1), ln1_bias=t(D, scale=0.1),
      w1=t(D, F, scale=D ** -0.5), b1=t(F, scale=0.1),
      w2=t(F, D, scale=F ** -0.5), b2=t(D, scale=0.1),
      ln2_scale=1 + t(D, scale=0.1), ln2_bias=t(D, scale=0.1))
  return t(B, T, D), w, t(B, T, D)


def _f64(w):
  return att.LayerWeights(*(v.double() for v in w))


def _pre64(x, w):
  return att.ffn_preactivation(x.double(), _f64(w))


def _masked(mask):
  """`run` and `saved` of the plain layer under the fixed ReLU mask."""
  return (lambda x, w: att.layer_math(x, w, mask),
          lambda x, w: att.layer_forward_saved(x, w, mask))


def _float64_mask(x, w):
  """`saved` giving the float64 plain mask: no flip, the gate of before
  the mask rule."""
  return lambda a, b: (None, att.Residuals(**dict(
      dict.fromkeys(att.Residuals._fields), h=torch.relu(_pre64(a, b)))))


def _reach(x, w, g):
  relu = {}
  att.compare_grads_with_plain(x, w, g, run=att.layer_math, relu=relu)
  return relu["reach"]


def _kink_case(seed=0, frac=0.4):
  """x, w, g with the FFN pre-activation of one entry moved to frac x the
  gate's reach above zero (through b1: the other rows of that column
  move by the same few 1e-5), and that entry's index."""
  x, w, g = _case(seed)
  pre = _pre64(x, w)
  idx = np.unravel_index(int(pre.abs().argmin()), pre.shape)
  r = _reach(x, w, g)
  b1 = w.b1.double().clone()
  b1[idx[-1]] -= float(pre[idx]) - frac * r
  w = w._replace(b1=b1.float())
  return x, w, g, idx


def test_a_flip_within_reach_is_decided_by_the_forwards_own_mask():
  x, w, g, idx = _kink_case()
  pre = _pre64(x, w)
  relu = {}
  att.compare_grads_with_plain(x, w, g, run=att.layer_math, relu=relu)
  assert 0 < float(pre[idx]) <= relu["reach"], (float(pre[idx]), relu)
  flipped = pre > 0
  flipped[idx] = ~flipped[idx]
  run, saved = _masked(flipped)

  # without the mask rule the flip fails the gate: the nudged copies of
  # the plain layer did not take that kink
  ok, report = att.compare_grads_with_plain(x, w, g, run=run,
                                            saved=_float64_mask(x, w))
  assert not ok, report
  assert sum(r["mask_excused"] for r in report.values()) == 0

  relu = {}
  ok, report = att.compare_grads_with_plain(x, w, g, run=run, saved=saved,
                                            relu=relu)
  assert ok, report
  assert relu["flips"] == relu["flips_within_reach"] == 1 and relu["decided"]
  assert sum(r["mask_excused"] for r in report.values()) > 0
  # only the flipped sample's rows of dx move: no other sample is excused
  assert report["x"]["mask_excused"] <= T * D


def test_a_flip_beyond_reach_is_refused():
  """A forward that turns over a pre-activation far from zero (the
  largest) fails, and the rule excuses nothing."""
  x, w, g = _case(1)
  pre = _pre64(x, w)
  idx = np.unravel_index(int(pre.abs().argmax()), pre.shape)
  flipped = pre > 0
  flipped[idx] = ~flipped[idx]
  relu = {}
  ok, report = att.compare_grads_with_plain(x, w, g, *_masked(flipped),
                                            relu=relu)
  assert not ok
  assert relu["flips"] == 1 and relu["flips_within_reach"] == 0
  assert not relu["decided"]
  assert sum(r["mask_excused"] for r in report.values()) == 0


def test_an_error_away_from_the_kink_is_still_refused():
  """With a flip within reach decided, a backward 0.1% off on another
  sample's rows still fails there."""
  x, w, g, idx = _kink_case()
  pre = _pre64(x, w)
  flipped = pre > 0
  flipped[idx] = ~flipped[idx]
  run, saved = _masked(flipped)
  other = (idx[0] + 1) % B

  class Scaled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
      return y

    @staticmethod
    def backward(ctx, d):
      scale = torch.ones(B, 1, 1)
      scale[other] = 1.001
      return d * scale

  ok, report = att.compare_grads_with_plain(
      x, w, g, run=lambda a, b: Scaled.apply(run(a, b)), saved=saved)
  assert not ok
  assert report["x"]["failed"] > 0
