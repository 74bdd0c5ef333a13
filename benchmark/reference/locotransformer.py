"""Plain PyTorch reference of the LocoTransformer actor-critic and its PPO
step, written from the published description (Yang et al., "Learning
Vision-Guided Quadrupedal Locomotion End-to-End with Cross-Modal
Transformers", ICLR 2022; the configs' `encoder`, `net` and `ppo`
sections).  It imports nothing of the program: parameters are a dict of
tensors under the names the program's module uses, so that the benchmark
can hand the same weights to both sides.

Everything here is float32 with torch's own operations, no fused kernel:
  * tokenizer: proprio MLP (ReLU) -> projection (ReLU) -> one token; the
    depth frames through the Nature CNN (ReLU after each conv) and a 1x1
    conv -> 16 spatial tokens, row-major;
  * per net (policy, value) a stack of single-head post-norm layers
    (LayerNorm eps 1e-6, ReLU FFN), pooled as the state token beside the
    mean of the visual tokens, then an MLP head;
  * a state-independent Gaussian: logstd clamped to [-5, 2].
The PPO step: GAE with the time-limit filter, per-minibatch advantage
normalisation (Bessel), the value step first, then the clipped surrogate
with entropy bonus on the updated parameters; each optimizer clips its
set's global gradient norm to 0.5 and applies Adam (eps 1e-5 outside the
square root, bias-corrected moments).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2 * math.pi)
TOKEN_DIM = 64
CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))   # (out channels, kernel, stride)
FRAMES = 4
IMG = 64


def proprio_dim(env_build: dict) -> int:
  """Width of the observation's proprio head (sorted sensor names: IMU
  history 12, last actions 36, motor angles 36, displacement 9, goal 6,
  direction 2)."""
  d = 12 + 36
  if env_build.get("random_dir"):
    d += 2
  if env_build.get("goal"):
    d += 6
  if not env_build.get("no_displacement"):
    d += 3 * (7 if env_build.get("rotate_sensor") else 3)
  if env_build.get("add_last_action_input"):
    d += 36
  return d


def action_dim(env_build: dict) -> int:
  return 6 if env_build.get("diagonal_act") else 12


def _conv_out(h: int, k: int, s: int) -> int:
  return (h - k) // s + 1


def forward_flops(params: dict):
  """FLOPs of one sample's forward: (tokenizer, policy stack + head,
  value stack + head), counting each multiply-add of a product or
  convolution as 2 (the layers' by harness/costs.layer_cost)."""
  from harness.costs import layer_cost
  eb = params["env"]["env_build"]
  P, A = proprio_dim(eb), action_dim(eb)
  hid = list(params["encoder"]["hidden_shapes"])
  app = list(params["net"]["append_hidden_shapes"])
  D = TOKEN_DIM
  mlp = lambda dims: sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
  tok = mlp([P] + hid + [D])
  h, c_in = IMG, FRAMES
  for c, k, s in CONVS:
    h = _conv_out(h, k, s)
    tok += 2 * c_in * k * k * c * h * h
    c_in = c
  n_vis = h * h
  tok += 2 * c_in * D * n_vis
  T = 1 + n_vis
  layers = sum(layer_cost(1, T, D, ff)[1]
               for _, ff in params["net"]["transformer_params"])
  return tok, layers + mlp([2 * D] + app + [A]), layers + mlp(
      [2 * D] + app + [1])


def _layers(params: dict) -> List[Tuple[int, int]]:
  return [tuple(p) for p in params["net"]["transformer_params"]]


def spec(params: dict) -> List[Tuple[str, tuple, str]]:
  """(name, shape, init kind) of every parameter, in a fixed order.
  Kinds: "fanin" U(+-1/sqrt(fan_in)) with bias 0.1, "he" U(+-sqrt(6 /
  fan_in)) with bias 0, "lecun" U(+-sqrt(3 / fan_in)) with bias 0,
  "small" U(+-3e-3), "one", "zero", "logstd"."""
  eb = params["env"]["env_build"]
  P, A = proprio_dim(eb), action_dim(eb)
  hid = list(params["encoder"]["hidden_shapes"])
  app = list(params["net"]["append_hidden_shapes"])
  out: List[Tuple[str, tuple, str]] = [("logstd", (A,), "logstd")]

  def linear(name, i, o, kind):
    out.append((f"{name}.weight", (o, i), kind))
    out.append((f"{name}.bias", (o,), kind + ".bias"))

  dims = [P] + hid
  for j, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
    linear(f"encoder.state_mlp.layers.{j}", i, o, "fanin")
  linear("encoder.state_proj", hid[-1], TOKEN_DIM, "fanin")
  c_in = FRAMES
  for j, (c, k, _) in enumerate(CONVS):
    out.append((f"encoder.nature.convs.{j}.weight", (c, c_in, k, k), "he"))
    out.append((f"encoder.nature.convs.{j}.bias", (c,), "he.bias"))
    c_in = c
  out.append(("encoder.token_conv.weight", (TOKEN_DIM, c_in, 1, 1), "he"))
  out.append(("encoder.token_conv.bias", (TOKEN_DIM,), "he.bias"))
  D = TOKEN_DIM
  for net in ("pf", "vf"):
    for j, (_, ff) in enumerate(_layers(params)):
      pre = f"{net}_layers.{j}"
      for n in ("query", "key", "value", "out"):
        linear(f"{pre}.{n}", D, D, "lecun")
      out.append((f"{pre}.norm1.weight", (D,), "one"))
      out.append((f"{pre}.norm1.bias", (D,), "zero"))
      linear(f"{pre}.ff1", D, ff, "lecun")
      linear(f"{pre}.ff2", ff, D, "lecun")
      out.append((f"{pre}.norm2.weight", (D,), "one"))
      out.append((f"{pre}.norm2.bias", (D,), "zero"))
  for net, width in (("pf", A), ("vf", 1)):
    dims = [2 * D] + app + [width]
    for j, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
      linear(f"{net}_mlp.layers.{j}", i, o,
             "small" if j == len(dims) - 2 else "fanin")
  return out


def groups(names) -> Dict[str, List[str]]:
  """The two optimizers' parameter sets: the shared tokenizer belongs to
  both, the value net's layers and head to "vf", the rest to "pf"."""
  pf, vf = [], []
  for n in names:
    if n.startswith("encoder."):
      pf.append(n)
      vf.append(n)
    elif n.startswith("vf_"):
      vf.append(n)
    else:
      pf.append(n)
  return {"pf": pf, "vf": vf}


def _layer(w: dict, pre: str, x):
  B, T, D = x.shape
  lin = lambda n, y: F.linear(y, w[f"{pre}.{n}.weight"], w[f"{pre}.{n}.bias"])
  q, k, v = lin("query", x), lin("key", x), lin("value", x)
  a = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(D), dim=-1)
  x = F.layer_norm(x + lin("out", a @ v), (D,), w[f"{pre}.norm1.weight"],
                   w[f"{pre}.norm1.bias"], eps=1e-6)
  f = lin("ff2", torch.relu(lin("ff1", x)))
  return F.layer_norm(x + f, (D,), w[f"{pre}.norm2.weight"],
                      w[f"{pre}.norm2.bias"], eps=1e-6)


def _mlp(w: dict, pre: str, x, n: int):
  for j in range(n):
    x = F.linear(x, w[f"{pre}.layers.{j}.weight"], w[f"{pre}.layers.{j}.bias"])
    if j < n - 1:
      x = torch.relu(x)
  return x


def _state_mlp(w, x, n):
  for j in range(n):
    x = torch.relu(F.linear(x, w[f"encoder.state_mlp.layers.{j}.weight"],
                            w[f"encoder.state_mlp.layers.{j}.bias"]))
  return x


class Net:
  """The actor-critic's forward over a parameter dict."""

  def __init__(self, params: dict):
    self.P = proprio_dim(params["env"]["env_build"])
    self.n_layers = len(_layers(params))
    self.n_state = len(params["encoder"]["hidden_shapes"])
    self.n_head = len(params["net"]["append_hidden_shapes"]) + 1

  def tokens(self, w, x):
    s = _state_mlp(w, x[:, :self.P], self.n_state)
    s = torch.relu(F.linear(s, w["encoder.state_proj.weight"],
                            w["encoder.state_proj.bias"]))
    img = x[:, self.P:].reshape(-1, FRAMES, IMG, IMG)
    for j, (_, _, st) in enumerate(CONVS):
      img = torch.relu(F.conv2d(img, w[f"encoder.nature.convs.{j}.weight"],
                                w[f"encoder.nature.convs.{j}.bias"],
                                stride=st))
    img = F.conv2d(img, w["encoder.token_conv.weight"],
                   w["encoder.token_conv.bias"])
    vis = img.flatten(2).transpose(1, 2)
    return torch.cat([s[:, None], vis], dim=1)

  def _stack(self, w, net, t):
    for j in range(self.n_layers):
      t = _layer(w, f"{net}_layers.{j}", t)
    pooled = torch.cat([t[:, 0], t[:, 1:].mean(dim=1)], dim=-1)
    return _mlp(w, f"{net}_mlp", pooled, self.n_head)

  def pi(self, w, x):
    mean = self._stack(w, "pf", self.tokens(w, x))
    logstd = torch.clamp(w["logstd"], -5.0, 2.0)
    return mean, torch.exp(logstd).expand_as(mean), logstd

  def v(self, w, x):
    return self._stack(w, "vf", self.tokens(w, x))

  def pi_v(self, w, x):
    t = self.tokens(w, x)
    mean = self._stack(w, "pf", t)
    logstd = torch.clamp(w["logstd"], -5.0, 2.0)
    return (mean, torch.exp(logstd).expand_as(mean)), self._stack(w, "vf", t)


def gae(rewards, values, terminals, time_limits, last_value, gamma, tau):
  """(advantages, returns), each (T, E), in float64: the recursion
  A_t = delta_t + gamma tau (1 - d_t) A_{t+1}, zeroed at time-limit
  steps (the time-limit filter)."""
  r, v = rewards.double(), values.double()
  d, tl = terminals.double(), time_limits.double()
  v_next = torch.cat([v[1:], last_value.double()[None]], dim=0)
  A = torch.zeros_like(v[0])
  advs = []
  for t in reversed(range(r.shape[0])):
    A = r[t] + (1 - d[t]) * gamma * v_next[t] - v[t] + (
        1 - d[t]) * gamma * tau * A
    A = A * (1 - tl[t])
    advs.append(A)
  advs = torch.stack(advs[::-1])
  return advs, advs + v


class Adam:
  """Clip the set's global gradient norm to `clip`, then Adam."""
  B1, B2 = 0.9, 0.999

  def __init__(self, names, lr, eps=1e-5, clip=0.5):
    self.names, self.lr, self.eps, self.clip = list(names), lr, eps, clip
    self.mu = self.nu = None
    self.count = 0

  def step(self, w: dict, grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Updates w in place; returns the clipped gradients."""
    norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
    factor = min(1.0, self.clip / float(norm))
    g = [x * factor for x in grads]
    if self.mu is None:
      self.mu = [torch.zeros_like(x) for x in g]
      self.nu = [torch.zeros_like(x) for x in g]
    self.count += 1
    b1, b2 = self.B1, self.B2
    for i, n in enumerate(self.names):
      self.mu[i] = b1 * self.mu[i] + (1 - b1) * g[i]
      self.nu[i] = b2 * self.nu[i] + (1 - b2) * g[i] * g[i]
      step = (self.mu[i] / (1 - b1 ** self.count)) / (
          torch.sqrt(self.nu[i] / (1 - b2 ** self.count)) + self.eps)
      with torch.no_grad():
        w[n].sub_(self.lr * step)
    return g


def normal_log_prob(mean, std, acts):
  return torch.sum(-0.5 * ((acts - mean) / std) ** 2 - torch.log(std)
                   - 0.5 * LOG_2PI, dim=-1, keepdim=True)


def ppo_steps(params: dict, w: dict, batches, n_steps: int):
  """Run the first `n_steps` PPO minibatch steps from weights `w` (a dict
  of leaf tensors, updated in place).  batches[k] = (obs, acts, advs,
  rets, old_logp) of step k.  Returns per step (vf_loss, pf_loss), and the
  clipped gradients of the first step per set: {"vf": [...], "pf": [...]}
  in `groups` order."""
  ppo = params["ppo"]
  net = Net(params)
  sets = groups(list(w))
  opt = {k: Adam(sets[k], ppo[{"pf": "plr", "vf": "vlr"}[k]]) for k in sets}
  clip, ent_c = ppo.get("clip_para", 0.2), ppo.get("entropy_coeff", 0.001)
  losses, first = [], {}
  for k in range(n_steps):
    obs, acts, advs, rets, old_logp = batches[k]
    advs = (advs - advs.mean()) / (advs.std() + 1e-5)
    leaves = [w[n].requires_grad_(True) for n in sets["vf"]]
    vf_loss = torch.mean((net.v(w, obs) - rets) ** 2)
    g = torch.autograd.grad(vf_loss, leaves, allow_unused=True)
    g = [torch.zeros_like(p) if x is None else x for x, p in zip(g, leaves)]
    for p in leaves:
      p.requires_grad_(False)
    g_vf = opt["vf"].step(w, g)
    leaves = [w[n].requires_grad_(True) for n in sets["pf"]]
    mean, std, _ = net.pi(w, obs)
    logp = normal_log_prob(mean, std, acts)
    ent = torch.sum(0.5 + 0.5 * LOG_2PI + torch.log(std), dim=-1,
                    keepdim=True)
    ratio = torch.exp(logp - old_logp)
    surr = torch.minimum(ratio * advs,
                         torch.clamp(ratio, 1 - clip, 1 + clip) * advs)
    pf_loss = -surr.mean() - ent_c * ent.mean()
    g = torch.autograd.grad(pf_loss, leaves, allow_unused=True)
    g = [torch.zeros_like(p) if x is None else x for x, p in zip(g, leaves)]
    for p in leaves:
      p.requires_grad_(False)
    g_pf = opt["pf"].step(w, g)
    if k == 0:
      first = {"vf": g_vf, "pf": g_pf}
    losses.append((float(vf_loss.detach()), float(pf_loss.detach())))
  return losses, first, sets
