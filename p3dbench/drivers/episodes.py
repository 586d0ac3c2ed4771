"""Closed loop of headless episodes, as ``run --preset ...`` runs one.

Each episode starts from one of ``scenes`` uniform scenes, kept on the
device and never written, and runs ``warmup`` and then ``steps`` steps
through ``simulate_dense_adaptive`` with ``chunk``-step windows from the
configuration's cell capacity. The ladder's path depends on the scene
(two of the eight probe the culled rung), so every run takes the same
set of scenes, drawn from fixed sub-seeds, and the seed orders them;
whole rounds of the set follow one another until the window's time is
up, and the round that straddles its end runs to its end and counts. The
rate is every committed step over the whole wall time. Only the sampled
episode's end state is held, so the window's device memory peak is the
program's, the same for every seed. A traced run profiles one episode.

Correctness: the output of an episode drawn from the seed (one of the
first round) is held against the plain reference's trajectory of the same
length from the same scene (float64): the median and the 99th percentile
of the per-particle distances at the end; and no committed window of any
episode may have masked rows. The
dynamics amplify rounding, so a particle or two of a sound run end far
from the reference's, and the largest distance cannot tell a wrong
particle from them.
"""

from __future__ import annotations

import random
import time

import torch

from .. import compare
from ..reference import particle_life as ref
from ..scene import uniform_scene
from ..trace import span
from .common import law, sim_config, summarise


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.episode_s = []   # (scene, wall seconds) per timed episode
        self.caps = {}        # scene -> its committed windows' capacities
        self.windows = []     # every committed window: (steps, cap, masked)
        self.kept = None      # the sampled episode's scene
        # the sampled episode: one of the first round, drawn from the seed
        self.kept_index = random.Random(self.seed).randrange(
            traffic["scenes"])
        self.seen = 0         # episodes run since set-up
        self.units = 0

    def setup(self):
        import particle3d_tpu_torch as P

        self.P = P
        c = self.config
        ones = torch.ones(c["n"], device=self.device)
        self.scenes = [scene_of(c, k, self.device)
                       for k in range(self.traffic["scenes"])]
        self.states = [P.ParticleState(p, v, s, ones, torch.zeros_like(p))
                       for p, v, s in self.scenes]
        self.kept_pos = torch.empty_like(self.scenes[0][0])
        self.order = list(range(len(self.scenes)))
        random.Random(self.seed).shuffle(self.order)
        self.cfg = sim_config(c)
        # builds and loads the kernels: the cell list's, and the culled
        # all-pairs rung's, onto which the ladder probes or falls back
        self.episode(self.order[0])
        P.simulate_culled(self.states[0], self.cfg, c["dt"], 1)

    def episode(self, k):
        t = self.traffic
        with span("episode"):
            with span("warmup"):
                st = self.P.warmup(self.states[k], self.cfg)
            out, cap, hist = self.P.simulate_dense_adaptive(
                st, self.cfg, self.config["dt"], t["steps"], chunk=t["chunk"])
        return out, hist

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds):
        self._sync()
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            for k in self.order:
                te = time.perf_counter()
                out, hist = self.episode(k)
                self.episode_s.append((k, time.perf_counter() - te))
                self.keep(k, out, hist)
                del out
                steps += self.traffic["steps"]
        self._sync()
        wall = time.perf_counter() - t0
        self.units = len(self.episode_s)
        return {"steps_per_s": steps / wall}

    def keep(self, k, out, hist):
        """Record an episode's windows, and copy its end positions into the
        slot made at set-up if it is the seed's sampled episode: nothing
        else of an episode outlives it, so that what the harness holds on
        the device while the program runs, and the window's memory peak,
        are the same for every seed and number of rounds."""
        if self.seen == self.kept_index:
            self.kept_pos.copy_(out.positions)
            self.kept = k
        self.seen += 1
        self.caps.setdefault(k, [c for _, c, _ in hist])
        self.windows.extend(hist)

    def traced(self):
        """One episode of the set's ``trace_scene``, the same in every
        traced run: scenes differ in their path (two of the eight probe
        the culled rung), and so would the per-layer readings."""
        k = self.traffic["trace_scene"]
        self.kept_index = self.seen
        out, hist = self.episode(k)
        self.keep(k, out, hist)
        del out
        self.units = 1
        return self.traffic["steps"]

    def summary(self, trace):
        from ..reference.pairs import unordered_pairs

        c = self.config
        ends = [self.scenes[self.kept][0], self.kept_pos]
        pairs = sum(unordered_pairs(p, c["world_size"], ref.CUTOFF)
                    for p in ends) / len(ends)
        return summarise(trace, pairs=pairs, n=c["n"],
                         wrap=c["boundary"] == "wrap")

    def context(self):
        lines = [f"episodes {self.seen}; committed capacities of each "
                 f"scene's windows: {dict(sorted(self.caps.items()))}"]
        if self.episode_s:
            lines.append("episode wall seconds (scene, s): " + ", ".join(
                f"({k}, {w:.4f})" for k, w in self.episode_s))
        return lines

    def release(self):
        self.sample = (self.scenes[self.kept], self.kept_pos, self.windows)
        self.states = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        return episode_checks(*self.sample, self.config, self.traffic)


def scene_of(config, k, device):
    """Scene k of the set: a uniform scene from sub-seed k."""
    return uniform_scene(k, config["n"], config["world_size"],
                         config["id_count"], device)


def control_checks(config, traffic, seed, device):
    """The comparisons with the control, the reference in float32 on TF32-
    rounded displacements, in the program's place."""
    scene = scene_of(config, seed % traffic["scenes"], device)
    pos = reference_trajectory(scene, config, traffic["steps"], control=True)
    return episode_checks(scene, pos, [], config, traffic)


def reference_trajectory(scene, config, steps, control=False):
    """Positions after ``steps`` reference steps from ``scene``: float64,
    or, for the control, float32 with the displacements taken from TF32-
    rounded positions."""
    pos, vel, spc = scene
    dtype = torch.float32 if control else torch.float64
    p, v = pos.to(dtype), vel.to(dtype)
    lw = law(config)
    for _ in range(steps):
        g = ref.round_tf32(p) if control else None
        p, v = ref.euler_step(p, v, spc, lw, config["dt"], geometry_pos=g)
    return p


def episode_checks(scene, pos, hist, config, traffic):
    want = reference_trajectory(scene, config, traffic["steps"])
    gaps = compare.position_gaps(pos, want, config["world_size"])
    lim = traffic["limits"]
    return [("gap_median", float(gaps.quantile(0.5)), lim["gap_median"]),
            ("gap_q99", float(gaps.quantile(0.99)), lim["gap_q99"]),
            ("masked_windows", sum(1 for h in hist if h[2]), 0)]
