"""Closed loop of one viewer on the interactive app.

Set-up builds one ``SimulationApp`` on the seed's scene. Each frame runs
``run_steps(steps_per_frame)`` and then ``render(width, height)``, whose
image is copied into host memory; the next frame starts when it is there.
A frame's time runs from the start of its step batch until its image is
in host memory. Frames follow one another until the window's time is up;
the one that straddles its end finishes and counts.

Correctness follows the program from its own state: for the window's
first frame and frames drawn from the seed, the state before the frame
is kept, and after the window the plain reference advances it by the
frame's steps (float64) and renders the program's new state, against
which the program's state and image are held. The start is checked apart: the app's state as built equals
the scene.
"""

from __future__ import annotations

import statistics
import time

import torch

from .. import compare
from ..reference import particle_life as ref
from ..reference import render as ref_render
from ..scene import uniform_scene
from ..trace import span
from .common import chosen, law, sim_config, summarise


def camera(config, traffic) -> dict:
    """The viewer's pose: the reference's starting camera for the box."""
    c = dict(traffic["camera"])
    c["position"] = [c["position"][0], c["position"][1],
                     c["depth_over_world"] * config["world_size"]]
    return c


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.samples = []    # (index, pos before, vel before, pos, vel, image)
        self.frames_s, self.render_s = [], []
        self.units = 0
        self.index = 0

    def setup(self):
        import particle3d_tpu_torch as P

        c = self.config
        pos, vel, spc = uniform_scene(self.seed, c["n"], c["world_size"],
                                      c["id_count"], self.device)
        self.species = spc
        st = P.ParticleState(pos, vel, spc, torch.ones(c["n"], device=self.device),
                             torch.zeros_like(pos))
        self.app = P.SimulationApp(state=st, cfg=sim_config(c),
                                   device=self.device)
        self.start_gap = max(
            float((self.app.state.positions - pos).abs().max()),
            float((self.app.state.velocities - vel).abs().max()))
        # the app's last rung, past its largest capacity: the culled
        # all-pairs sweep, which this traffic reaches as the scene clusters
        P.simulate_culled(st, self.app.cfg, self.config["dt"], 1)
        for _ in range(self.traffic["warmup_frames"]):
            self.frame(sample=False)
        self.frames_s, self.render_s = [], []

    def frame(self, sample: bool):
        t = self.traffic
        app = self.app
        # the first frame of a window, and about one in ``sample_every``
        # drawn from the seed: a short traced window has one at least
        keep = (sample and len(self.samples) < t["max_samples"]
                and (not self.samples
                     or chosen(self.seed, self.index, t["sample_every"])))
        if keep:
            before = (app.state.positions.clone(), app.state.velocities.clone())
        t0 = time.perf_counter()
        with span("run_steps"):
            app.run_steps(t["steps_per_frame"])
        t1 = time.perf_counter()
        with span("render"):
            img = app.render(t["width"], t["height"])
        t2 = time.perf_counter()
        self.frames_s.append(t2 - t0)
        self.render_s.append(t2 - t1)
        if keep:
            self.samples.append((self.index, *before,
                                 app.state.positions.clone(),
                                 app.state.velocities.clone(), img))
        self.index += 1

    def window(self, seconds):
        t0 = time.perf_counter()
        while True:
            self.frame(sample=True)
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.units = len(self.frames_s)
        q = statistics.quantiles(self.frames_s, n=20)
        return {"steps_per_s": self.units * self.traffic["steps_per_frame"]
                / wall,
                "frame_ms_p95": q[18] * 1e3}

    def before_trace(self):
        """Frames timed without the profiler, which slows the host: the
        renderer's time is read from these."""
        self.frames_s, self.render_s = [], []
        for _ in range(self.traffic["trace_frames"]):
            self.frame(sample=True)
        self.untraced_render_s = list(self.render_s)

    def traced(self):
        """The profiled frames; returns their steps."""
        for _ in range(self.traffic["trace_frames"]):
            self.frame(sample=True)
        self.units = 2 * self.traffic["trace_frames"]
        return self.traffic["trace_frames"] * self.traffic["steps_per_frame"]

    def summary(self, trace):
        from ..reference.pairs import unordered_pairs

        c = self.config
        ends = [self.samples[0][1], self.app.state.positions] if self.samples \
            else [self.app.state.positions]
        pairs = sum(unordered_pairs(p, c["world_size"], ref.CUTOFF)
                    for p in ends) / len(ends)
        return summarise(trace, pairs=pairs, n=c["n"],
                         wrap=c["boundary"] == "wrap",
                         extra={"render_s": self.untraced_render_s})

    def context(self):
        m = self.app.metrics()
        keys = ("step_index", "cell_capacity", "max_drift", "drift_budget",
                "per_step_rebuild", "cell_fallback")
        return [f"frames {len(self.frames_s)}, samples "
                f"{[s[0] for s in self.samples]}; app "
                + ", ".join(f"{k}={m.get(k)}" for k in keys)]

    def release(self):
        self.app = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        return frame_checks(self.samples, self.species, self.config,
                            self.traffic, self.start_gap)


def frame_checks(samples, species, config, traffic, start_gap, control=False):
    """Each sampled frame's state against the reference's steps from the
    state before it, and its image against the reference's rendering of
    the program's state. ``control`` puts the reference in float32 on
    TF32-rounded positions in the program's place."""
    lw, w = law(config), config["world_size"]
    cam = camera(config, traffic)
    gap_pos = gap_vel = mism = 0.0
    for _, p0, v0, p1, v1, img in samples:
        p, v = p0.double(), v0.double()
        for _ in range(traffic["steps_per_frame"]):
            p, v = ref.euler_step(p, v, species, lw, config["dt"])
        want = ref_render.render(p1.double(), species, config["colors"], w,
                                 cam, traffic["width"], traffic["height"])
        gap_pos = max(gap_pos, float(compare.position_gaps(p1, p, w).max()))
        gap_vel = max(gap_vel, compare.velocity_gap(v1, v))
        mism = max(mism, compare.pixel_mismatch(img, want.cpu()))
    lim = traffic["limits"]
    return [("start_gap", start_gap, 0.0),
            ("frames_checked", -len(samples), -1),
            ("state_gap", gap_pos, lim["state_gap"]),
            ("velocity_gap", gap_vel, lim["velocity_gap"]),
            ("pixel_mismatch", mism, lim["pixel_mismatch"])]


def control_checks(config, traffic, seed, device):
    """The control in the program's place for one frame, on the state that
    the app reaches after ``control_lead`` frames from the seed's scene:
    float32 steps on TF32-rounded displacements, and a render of TF32-
    rounded positions."""
    cell = Cell(config, {**traffic, "warmup_frames": traffic["control_lead"]},
                seed, device)
    cell.setup()
    p0 = cell.app.state.positions.clone()
    v0 = cell.app.state.velocities.clone()
    cell.release()
    lw, spc = law(config), cell.species
    pc, vc = p0, v0
    for _ in range(traffic["steps_per_frame"]):
        pc, vc = ref.euler_step(pc, vc, spc, lw, config["dt"],
                                geometry_pos=ref.round_tf32(pc))
    img = ref_render.render(ref.round_tf32(pc).double(), spc,
                            config["colors"], config["world_size"],
                            camera(config, traffic), traffic["width"],
                            traffic["height"]).cpu()
    return frame_checks([(0, p0, v0, pc, vc, img)], spc, config, traffic, 0.0)
