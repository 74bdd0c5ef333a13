"""The port's viewer, statistics-sweep, env-viewer and converter starters
on the CPU over a cut horizon, on a copy of the committed JAX run
mmdr_moving_10M: the converter writes the port's snapshot into another
run directory, the viewer replays it (and the .flax of the copy: the same
episodes bit for bit) and writes a non-empty depth mp4, the sweep reports
the statistics of the same episodes, the env viewer its rate.  Nothing
is written under runs/."""
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

from vision4leg_torch.starter import (convert_jax_run, env_viewer,
                                      locotransformer_viewer,
                                      total_randomize_statistics,
                                      viewer_common)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
RUN = osp.join(ROOT, "runs", "mmdr_moving_10M", "A1MoveGround", "0")
HORIZON = 3
EPISODES = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """(log_dir, config): id "jax" is a copy of the JAX run, id "port" the
  port's snapshot of it made by convert_jax_run."""
  log_dir = tmp_path_factory.mktemp("viewer_runs")
  jax_dir = log_dir / "jax" / "A1MoveGround" / "0"
  shutil.copytree(RUN, jax_dir)
  port_dir = log_dir / "port" / "A1MoveGround" / "0"
  r = convert_jax_run.main(["--run", str(jax_dir), "--out",
                            str(port_dir / "model"), "--device", "cpu"])
  assert r["module"] == "LocoTransformerActorCritic"
  assert np.isfinite(r["probe_mean"]).all()
  with pytest.raises(ValueError, match="inside the run"):
    convert_jax_run.convert_run(str(jax_dir), str(jax_dir / "model"),
                                device="cpu")
  return log_dir, str(jax_dir / "params.json")


def _argv(runs, run_id, *extra):
  log_dir, config = runs
  return ["--config", config, "--log_dir", str(log_dir), "--id", run_id,
          "--episodes", str(EPISODES), "--device", "cpu", *extra]


def test_viewer_replays_the_converted_snapshot(runs, capsys):
  video = str(runs[0] / "depth.mp4")
  out = viewer_common.run_viewer(locotransformer_viewer._build_module,
                                 _argv(runs, "port", "--video", video),
                                 horizon=HORIZON)
  text = capsys.readouterr().out
  assert "mean return" in text and "wrote" in text
  assert osp.getsize(video) > 0
  assert out["frames"].shape == (HORIZON, EPISODES, 64, 64)
  assert torch.isfinite(out["returns"]).all()
  assert bool((out["steps"] > 0).all())
  # the .flax snapshot of the JAX run: the same weights, the same episodes
  flax = viewer_common.run_viewer(locotransformer_viewer._build_module,
                                  _argv(runs, "jax"), horizon=HORIZON)
  assert torch.equal(flax["returns"], out["returns"])
  assert torch.equal(flax["pos"], out["pos"])


def test_statistics_sweep_reports_the_episodes(runs, capsys):
  stats = total_randomize_statistics.main(_argv(runs, "jax"),
                                          horizon=HORIZON)
  text = capsys.readouterr().out
  for key in ("success rate", "return: mean", "episode length",
              "forward distance", "subgoals hit"):
    assert key in text
  assert stats["episodes"] == EPISODES
  assert 0.0 <= stats["success_rate"] <= 1.0
  assert 0 < stats["episode_length_mean"] <= HORIZON
  # the viewer's episodes on the same seed: the same returns
  out = viewer_common.run_viewer(locotransformer_viewer._build_module,
                                 _argv(runs, "jax"), horizon=HORIZON)
  np.testing.assert_allclose(stats["return_mean"],
                             float(out["returns"].double().mean()),
                             rtol=1e-12)


def test_env_viewer_reports_its_rate(tmp_path):
  video = str(tmp_path / "env.mp4")
  r = env_viewer.main(["--config", osp.join(
      ROOT, "config/rl/static/locotransformer/thin-goal.json"),
      "--steps", "2", "--num_envs", "2", "--device", "cpu",
      "--video", video])
  assert r["env_steps_per_s"] > 0
  assert r["rewards"].shape == (2, 2)
  assert osp.getsize(video) > 0
