"""The yardstick against hand counts: pairs in the cutoff, the roofline's
arithmetic, the union of device intervals, the reference law and the
reference renderer."""

import math

import numpy as np
import pytest
import torch

from p3dbench import bounds, compare, trace
from p3dbench.reference import particle_life as ref
from p3dbench.reference import pairs
from p3dbench.reference import render as ref_render

LAW = dict(world_size=10.0, attraction_matrix=np.eye(5) * 0.5 + 0.1,
           min_pull_ratio=0.3, interaction_force=1.0,
           particle_effect_radius=2.0, coefficient=0.97,
           acceleration=[0.0, 0.0, 0.0])


def test_pairs_by_hand():
    pos = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.9, 0.0],
                        [4.8, 0.0, 0.0], [-4.8, 0.0, 0.0], [3.0, 3.0, 3.0]])
    # 0-1 (0.5), 0-2 (0.9), 1-2 (1.03: out), 3-4 across the seam (0.4)
    assert pairs.ordered_pairs(pos, 10.0, 1.0) == 6
    assert pairs.unordered_pairs(pos, 10.0, 1.0) == 3


@pytest.mark.parametrize("seed", [0, 1])
def test_pairs_against_all_pairs(seed):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((1500, 3), generator=g) * 8 - 4
    d = pos[None] - pos[:, None]
    d = d - 8 * torch.round(d / 8)
    d2 = (d * d).sum(-1)
    want = int(((d2 > 0) & (d2 < 1)).sum())
    assert pairs.ordered_pairs(pos, 8.0, 1.0, max_pairs=4096) == want
    assert pairs.ordered_pairs(pos, 8.0, 1.0) == want


def test_reference_law_against_all_pairs():
    g = torch.Generator().manual_seed(2)
    pos = (torch.rand((1200, 3), generator=g) * 10 - 5).double()
    spc = torch.randint(0, 5, (1200,), generator=g)
    got = ref.accelerations(pos, spc, LAW, max_pairs=10000)
    d = pos[None] - pos[:, None]
    d = d - 10 * torch.round(d / 10)
    dd = (d * d).sum(-1).sqrt()
    coef = torch.as_tensor(LAW["attraction_matrix"])[spc[:, None], spc[None]]
    m = 0.3
    mag = torch.where(dd < m, dd / m - 1, torch.where(
        (dd > m) & (dd < 1), coef * (1 - (2 * dd - 1 - m).abs() / (1 - m)),
        torch.zeros_like(dd)))
    ok = dd > 0
    s = torch.where(ok, mag / torch.where(ok, dd, torch.ones_like(dd)), 0.0)
    want = (d * s[..., None]).sum(1) * 2.0
    assert float((got - want).abs().max()) < 1e-12
    whole = ref.accelerations(pos, spc, LAW)
    assert float((whole - got).abs().max()) < 1e-12


def test_roofline_arithmetic():
    assert bounds.ops_two_sided(True) == 44
    assert bounds.ops_two_sided(False) == 37
    # positions and species in, forces out: 28 B a particle
    assert bounds.BYTES_PER_PARTICLE == 28
    # bound by bytes at a low pair count: 262,144 particles x 28 B
    t = bounds.least_seconds(1000.0, 262144, True)
    assert t == pytest.approx(262144 * 28 / 3.35e12)
    # bound by FP32 operations at a high one
    t = bounds.least_seconds(1e12, 10, True)
    assert t == pytest.approx(1e12 * 44 / 67e12)
    from p3dbench.harness import load_reader

    s = {"pairs": 1e12, "n": 10, "wrap": True, "steps": 2,
         "force_s": 4 * 1e12 * 44 / 67e12}
    assert load_reader("force_roofline").read(s) == pytest.approx(50.0)


def test_union_of_overlapping_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.2, 3.5), (5.0, 5.0)]
    assert trace.union_seconds(iv) == pytest.approx(3.0)
    t = trace.Trace([("a", s, e) for s, e in iv] + [("Memcpy HtoD", 6.0, 6.5)],
                    [("episode", -1.0, 10.0), ("render", 2.5, 2.9)], 10.0, 4)
    assert t.busy_s() == pytest.approx(3.5)
    assert t.launches() == 5
    gaps = t.idle_gaps()
    assert sorted(n for n, _ in gaps) == ["episode", "episode", "render"]
    assert all(g == pytest.approx(1.0) for _, g in gaps)
    from p3dbench.harness import load_reader

    s = {"busy_s": t.busy_s(), "window_s": 10.0}
    assert load_reader("device_idle_share").read(s) == pytest.approx(65.0)
    assert trace.layer_of("void column_sweep_kernel<8, true>(float*)") == "force"
    assert trace.layer_of("elementwise_kernel") is None


def test_spans_placed_by_the_marker():
    from types import SimpleNamespace as NS

    cuda = torch.autograd.DeviceType.CUDA

    def ev(name, s_us, e_us, dev=cuda):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=s_us, end=e_us))

    # the marker starts at 1,000 us on the profiler's clock, launched at
    # host time 50.0 s: host times map by +(0.001 - 50.0) s
    prof = NS(events=lambda: [ev("k2", 3000.0, 4000.0), ev("fill", 1000.0, 1001.0),
                              ev("host op", 0.0, 9000.0, dev=None),
                              ev("k1", 1500.0, 2000.0)])
    t = {"prof": prof, "marker_host": 50.0, "window_s": 0.01,
         "spans": [("render", 50.0015, 50.0035)]}
    tr = trace.Trace.from_profiler(t, 2)
    assert [n for n, _, _ in tr.ops] == ["k1", "k2"]
    assert tr.spans[0][1] == pytest.approx(0.0025)
    assert tr.idle_gaps() == [["render", pytest.approx(0.001)]]
    assert tr.busy_s() == pytest.approx(0.0015)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    got = ref.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]


def test_reference_render_by_hand():
    cam = dict(position=[0.0, 0.0, 10.0], pitch=0.0, yaw=0.0, fov_deg=90.0,
               near=0.001, far=1000.0)
    colors = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]
    pos = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 5.0]], dtype=torch.float64)
    img = ref_render.render(pos, torch.tensor([0, 1]), colors, 100.0, cam,
                            8, 8, border_samples=2)
    # both project to the image centre, seeding pixels 3-4; the nearer
    # (green, depth 5) wins the depth test
    assert img[3, 3].tolist() == [0, 255, 0] and img[4, 4].tolist() == [0, 255, 0]
    assert (img == torch.tensor([5, 5, 7], dtype=torch.uint8)).all(-1).any()
    assert compare.pixel_mismatch(img, img) == 0.0


def test_position_gaps_wrap():
    a = torch.tensor([[4.9, 0.0, 0.0]])
    b = torch.tensor([[-4.9, 0.0, 0.0]])
    assert float(compare.position_gaps(a, b, 10.0)[0]) == pytest.approx(0.2)


def test_frame_p95_rule():
    import statistics

    xs = list(range(1, 101))
    assert statistics.quantiles(xs, n=20)[18] == pytest.approx(95.95)
    assert math.isclose(bounds.PEAK_FP32, 67e12)
