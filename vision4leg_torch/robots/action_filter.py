"""Butterworth low-pass action filter, batched over envs (torch mirror of
vision4leg_tpu.robots.action_filter).

Reference: vision4leg/robots/action_filter.py (ActionFilterButter, default
order 2 lowpass with highcut [4.0] Hz at the control sampling rate
1/(time_step * action_repeat), minitaur.py:1445-1459).  The coefficients
are computed once with scipy in float64; the per-step IIR update is a
function of an (x_hist, y_hist) state that the env carries.

Off in every shipped config (enable_action_filter: false).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
from scipy import signal

ACTION_FILTER_ORDER = 2
ACTION_FILTER_HIGH_CUT = 4.0


class ButterCoeffs(NamedTuple):
  b: tuple  # (order+1,) numerator
  a: tuple  # (order+1,) denominator (a[0] == 1)


@dataclasses.dataclass
class FilterState:
  xhist: torch.Tensor  # (..., order, num_joints) past inputs, newest first
  yhist: torch.Tensor  # (..., order, num_joints) past outputs, newest first

  def replace(self, **kw) -> "FilterState":
    return dataclasses.replace(self, **kw)


def make_coeffs(sampling_rate: float,
                highcut: float = ACTION_FILTER_HIGH_CUT,
                order: int = ACTION_FILTER_ORDER) -> ButterCoeffs:
  b, a = signal.butter(order, highcut / (sampling_rate / 2.0),
                       btype="low")
  return ButterCoeffs(b=tuple(float(x) for x in b),
                      a=tuple(float(x) for x in a / a[0]))


def init_state(init_value: torch.Tensor,
               order: int = ACTION_FILTER_ORDER) -> FilterState:
  """init_history (action_filter.py): both histories prefilled with
  init_value (..., num_joints), so the filter starts at steady state."""
  tile = init_value[..., None, :].expand(
      init_value.shape[:-1] + (order, init_value.shape[-1])).clone()
  return FilterState(xhist=tile, yhist=tile.clone())


def apply(coeffs: ButterCoeffs, state: FilterState,
          x: torch.Tensor) -> Tuple[FilterState, torch.Tensor]:
  """Direct-form-I IIR step: y = b0 x + sum b_i x_-i - sum a_i y_-i, in
  the JAX package's order of terms."""
  b, a = coeffs
  y = b[0] * x
  for i in range(state.xhist.shape[-2]):
    y = (y + b[i + 1] * state.xhist[..., i, :]
         - a[i + 1] * state.yhist[..., i, :])
  push = lambda new, hist: torch.cat([new[..., None, :], hist[..., :-1, :]],
                                     dim=-2)
  return FilterState(xhist=push(x, state.xhist),
                     yhist=push(y, state.yhist)), y
