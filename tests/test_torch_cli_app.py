"""The port's app commands on the CPU: ``run --gif``, ``run
--checkpoint`` (plain and periodic) then ``resume``, ``run --record``
then ``replay``, and ``resume`` of a checkpoint the JAX package wrote.
Frames must be valid GIFs with the recorded count; resumed step counts
and states exact."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax
from particle3d_tpu import reference_config as jax_reference_config
from particle3d_tpu.state import init_scene as jax_init_scene
from particle3d_tpu.utils.checkpoint import save_checkpoint as jax_save

from particle3d_tpu_torch import __main__ as cli
from particle3d_tpu_torch.utils.checkpoint import load_checkpoint
from particle3d_tpu_torch.utils.trajio import TrajectoryReader

RUN = ["run", "--preset", "reference", "--n", "96", "--device", "cpu"]


def _json(capsys):
    out = capsys.readouterr().out
    return json.loads([l for l in out.splitlines() if l.startswith("{")][-1])


def test_run_gif(tmp_path, capsys):
    gif = str(tmp_path / "out.gif")
    cli.main(RUN + ["--steps", "12", "--snapshot-every", "4", "--gif", gif,
                    "--width", "120", "--height", "90"])
    rec = _json(capsys)
    assert rec["n"] == 96 and rec["steps"] == 12
    im = Image.open(gif)
    assert im.size == (120, 90) and getattr(im, "n_frames", 1) >= 1


def test_run_checkpoint_then_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    cli.main(RUN + ["--steps", "30", "--checkpoint", ck])
    assert _json(capsys)["steps"] == 30
    st30, cfg, step, _ = load_checkpoint(ck, device="cpu")
    assert step == 30
    rec = cli.main(["resume", "--checkpoint", ck, "--steps", "10", "--device",
                    "cpu"])
    assert rec == _json(capsys)
    assert rec["resumed_from"] == 30 and rec["now"] == 40
    st40, _, step, _ = load_checkpoint(ck, device="cpu")
    assert step == 40
    assert not torch.equal(st40.positions, st30.positions)


def test_periodic_checkpoint_restarts(tmp_path, capsys):
    """--checkpoint-every writes a snapshot each chunk, and a rerun of the
    same command resumes from it: a run cut after 20 steps and rerun to 40
    ends where an uncut 40-step run ends."""
    cut, full = str(tmp_path / "cut.npz"), str(tmp_path / "full.npz")
    cli.main(RUN + ["--steps", "20", "--checkpoint", cut, "--checkpoint-every",
                    "10"])
    cli.main(RUN + ["--steps", "40", "--checkpoint", cut, "--checkpoint-every",
                    "10"])
    cli.main(RUN + ["--steps", "40", "--checkpoint", full, "--checkpoint-every",
                    "10"])
    capsys.readouterr()
    a, _, sa, _ = load_checkpoint(cut, device="cpu")
    b, _, sb, _ = load_checkpoint(full, device="cpu")
    assert sa == sb == 40
    assert torch.equal(a.positions, b.positions)


def test_record_then_replay(tmp_path, capsys):
    traj, gif = str(tmp_path / "t.p3t"), str(tmp_path / "r.gif")
    cli.main(RUN + ["--steps", "10", "--snapshot-every", "4", "--record", traj])
    _json(capsys)
    tr = TrajectoryReader(traj)
    assert len(tr) == 3 and tr.n == 96  # 4 + 4 + a trailing 2
    assert tr.meta["snapshot_every"] == 4
    cli.main(["replay", "--traj", traj, "--gif", gif, "--width", "80",
              "--height", "60", "--device", "cpu"])
    assert "replayed 3 of 3 frames" in capsys.readouterr().out
    assert Image.open(gif).size == (80, 60)


def test_resume_a_jax_checkpoint(tmp_path, capsys):
    cfg = jax_reference_config()
    st = jax_init_scene(jax.random.PRNGKey(0), 64, cfg)
    ck = str(tmp_path / "jax.npz")
    jax_save(ck, st, cfg, 5)
    out = str(tmp_path / "out.npz")
    rec = cli.main(["resume", "--checkpoint", ck, "--steps", "3", "--out", out,
                    "--device", "cpu"])
    capsys.readouterr()
    assert rec["resumed_from"] == 5 and rec["now"] == 8
    assert np.isfinite(rec["kinetic_energy"])
    assert load_checkpoint(out, device="cpu")[2] == 8
