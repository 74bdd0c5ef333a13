"""The decision rule of tools/eval_jax_vs_port.py on fixed synthetic
episodes (no env, no model): the JAX package's and the port's evals of a
snapshot agree if their mean returns differ by at most 2.5 standard errors
of the difference (Welch) and their fall shares by at most 2.5 of theirs.
"""
import importlib.util
import os

import numpy as np
import pytest

_PATH = os.path.join(os.path.dirname(__file__), "..", "tools",
                     "eval_jax_vs_port.py")
_spec = importlib.util.spec_from_file_location("eval_jax_vs_port", _PATH)
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

H = 999


def _episodes(seed, mean, fall_share, n=96):
  """n returns ~ N(mean, 150) and step counts: the first round(fall_share
  n) episodes end early, the rest run the horizon."""
  rng = np.random.default_rng(seed)
  returns = rng.normal(mean, 150.0, n)
  steps = np.full(n, H)
  steps[:round(fall_share * n)] = rng.integers(50, H, round(fall_share * n))
  return returns, steps


def test_summary_of_fixed_episodes():
  s = tool.summary([1.0, 2.0, 3.0, 6.0], [999, 999, 10, 500], H)
  assert s["episodes"] == 4 and s["nonfinite"] == 0
  assert s["mean_return"] == pytest.approx(3.0)
  assert s["se_return"] == pytest.approx(np.std([1, 2, 3, 6], ddof=1) / 2)
  assert s["fall_share"] == 0.5
  assert s["mean_episode_length"] == pytest.approx(627.0)


def test_summary_leaves_a_nonfinite_return_out_and_counts_it():
  s = tool.summary([1.0, np.nan, 3.0], [999, 999, 999], H)
  assert s["nonfinite"] == 1 and s["mean_return"] == pytest.approx(2.0)


def test_two_samples_of_one_distribution_agree():
  a = tool.summary(*_episodes(0, 150.0, 0.40), H)
  b = tool.summary(*_episodes(1, 150.0, 0.40), H)
  d = tool.decide(a, b)
  assert d["means_agree"] and d["falls_agree"] and d["agree"]
  assert abs(d["mean_diff_in_se"]) <= tool.AGREE_SE


@pytest.mark.parametrize("shift,fall_b,means,falls", [
    (200.0, 0.40, False, True),     # the means 200 apart (~9 se)
    (0.0, 0.75, True, False),       # fall shares 0.40 against 0.75
])
def test_samples_that_differ_do_not_agree(shift, fall_b, means, falls):
  a = tool.summary(*_episodes(0, 150.0, 0.40), H)
  b = tool.summary(*_episodes(1, 150.0 + shift, fall_b), H)
  d = tool.decide(a, b)
  assert d["means_agree"] is means and d["falls_agree"] is falls
  assert not d["agree"]


def test_the_rule_at_its_edge():
  """Means exactly 2.5 standard errors apart agree; a hair beyond, not."""
  a = dict(episodes=100, mean_return=0.0, se_return=3.0, fall_share=0.5)
  b = dict(episodes=100, mean_return=12.5, se_return=4.0, fall_share=0.5)
  assert tool.decide(a, b)["means_agree"]
  assert not tool.decide(a, dict(b, mean_return=12.51))["means_agree"]
