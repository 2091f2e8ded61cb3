"""Parity of the port's simulation pieces with the JAX package on the CPU:
angles, the savgol filter, the comfort metrics, the scoring geometry, the
profile fits, the LQR step, the bicycle step and the 40-step rollout.

The JAX side runs under `jax.jit`, as JAX's scorer does, once per module
(`jax_ref`). Tolerances are stated per quantity beside each check; the
measured maxima (float32 unless said): `normalize_angle` 2.4e-7; savgol
7.6e-5 at max |y| 1615 (one float32 ulp); comfort signals 3.3e-5 at max
1615; velocity profiles 1.0e-4 (of 15 m/s: the jerk-regularised normal
equations are poorly conditioned in float32) and 8.0e-14 in float64;
simulated states after 40 steps 2.0e-5 in float32 and 2.8e-14 in float64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from matplotlib.path import Path as MplPath

import diffusiondrive_torch.evaluate.comfort as TC
import diffusiondrive_torch.evaluate.geometry as TG
import diffusiondrive_torch.evaluate.simulator as TS
import diffusiondrive_tpu.evaluate.comfort as JC
import diffusiondrive_tpu.evaluate.geometry as JG
import diffusiondrive_tpu.evaluate.simulator as JS
from diffusiondrive_torch.common.dataclasses import TrajectorySampling
from diffusiondrive_torch.common.enums import StateIndex
from diffusiondrive_torch.common.geometry import normalize_angle
from diffusiondrive_torch.evaluate.state_array import box_to_corners, get_pacifica_parameters
from diffusiondrive_torch.ops.savgol import savgol_filter_torch
from diffusiondrive_tpu.common.dataclasses import TrajectorySampling as JaxSampling
from diffusiondrive_tpu.common.geometry import normalize_angle as jax_normalize_angle
from diffusiondrive_tpu.evaluate.observation import pad_rings
from diffusiondrive_tpu.evaluate.vehicle import get_pacifica_parameters as jax_pacifica
from diffusiondrive_tpu.ops.savgol import savgol_filter_jax

S = StateIndex
T = 41
DT = 0.1
SAMPLING = TrajectorySampling(num_poses=40, interval_length=DT)
SAVGOL_ARGS = ((41, 2, 0, 1.0), (8, 2, 0, 1.0), (41, 2, 1, DT), (5, 2, 1, DT), (5, 3, 2, DT))
F32_EPS = float(np.finfo(np.float32).eps)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(got, want, atol, what):
    """Elementwise: max |got - want| <= atol (NaN where JAX has NaN)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    err = np.nanmax(np.abs(got - want)) if got.size else 0.0
    assert err <= atol, f"{what}: max abs err {err} > {atol}"
    return err


def ulps(want, n=8):
    """n float32 ulps of max |want| (at least of 1)."""
    return n * F32_EPS * max(1.0, float(np.nanmax(np.abs(want))))


# --------------------------------------------------------------------------- #
# Inputs, seeded
# --------------------------------------------------------------------------- #


def random_proposals(batch, seed):
    """(batch, 41, 11) proposals: noisy forward drives of 0-15 m/s."""
    rng = np.random.default_rng(seed)
    props = np.zeros((batch, T, S.size()), np.float32)
    v = rng.uniform(0, 15, batch)[:, None]
    time = np.arange(T) * DT
    props[..., S.X] = v * time + rng.normal(0, 0.3, (batch, T)).cumsum(-1) * DT
    props[..., S.Y] = rng.normal(0, 0.3, (batch, T)).cumsum(-1)
    props[..., S.HEADING] = rng.normal(0, 0.05, (batch, T)).cumsum(-1)
    return props


def oracle_proposals():
    """The closed-form proposals of `tests/test_simulator.py`: straight 8 and
    10 m/s, a 20 m and a 25 m circle, standing still, a 20 m lateral jump."""
    def straight(v):
        p = np.zeros((T, S.size()), np.float32)
        p[:, S.X] = v * DT * np.arange(T)
        p[:, S.VELOCITY_X] = v
        return p

    def circle(v, radius):
        p = np.zeros((T, S.size()), np.float32)
        omega, time = v / radius, np.arange(T) * DT
        p[:, S.X] = radius * np.sin(omega * time)
        p[:, S.Y] = radius * (1 - np.cos(omega * time))
        p[:, S.HEADING] = omega * time
        p[:, S.VELOCITY_X] = v
        return p

    jump = straight(5.0)
    jump[20:, S.Y] += 20.0
    return np.stack([straight(8.0), straight(10.0), circle(6.0, 20.0), circle(6.0, 25.0), straight(0.0), jump])


def comfort_states(seed=0, batch=16):
    """(batch, 41, 11) states with noisy accelerations and headings, as in
    `tests/test_scorer_edge_cases.py`; half of the rows also wrap headings."""
    rng = np.random.default_rng(seed)
    st = np.zeros((batch, T, S.size()), np.float32)
    st[..., S.ACCELERATION_X] = rng.normal(0, 2.0, (batch, T))
    st[..., S.ACCELERATION_Y] = rng.normal(0, 2.5, (batch, T))
    st[..., S.HEADING] = np.cumsum(rng.normal(0, 0.05, (batch, T)), -1)
    st[batch // 2:, :, S.HEADING] = np.cumsum(rng.normal(0.4, 0.3, (batch - batch // 2, T)), -1)
    st[batch // 2:, :, S.HEADING] = (st[batch // 2:, :, S.HEADING] + np.pi) % (2 * np.pi) - np.pi
    return st


def lqr_inputs(seed=3, batch=64):
    rng = np.random.default_rng(seed)
    cur = rng.normal(0, 1, (batch, S.size())).astype(np.float32)
    ref = rng.normal(0, 1, (batch, S.size())).astype(np.float32)
    cur[:, S.VELOCITY_X] = rng.uniform(0, 12, batch)
    cur[: batch // 4, S.VELOCITY_X] = rng.uniform(0, 0.2, batch // 4)   # stopping branch
    ref_v = rng.uniform(0, 12, batch).astype(np.float32)
    ref_v[: batch // 8] = rng.uniform(0, 0.2, batch // 8)
    curv = rng.normal(0, 0.05, (batch, 10)).astype(np.float32)
    return cur, ref, ref_v, curv


def _profiles(poses):
    return JS.velocity_curvature_profiles_from_poses(poses, DT, 1e-4, 1e-2)


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX output of this module, each under `jax.jit`."""
    out = {}
    angles = np.random.default_rng(0).uniform(-20, 20, 1000).astype(np.float32)
    out["angles"] = angles
    out["normalize_angle"] = np.asarray(jax.jit(lambda a: jax_normalize_angle(a, xp=jnp))(angles))

    y = np.random.default_rng(1).normal(0, 3, (6, T)).astype(np.float32)
    out["savgol_in"] = y
    for args in SAVGOL_ARGS:
        out[("savgol", args)] = np.asarray(jax.jit(lambda v, a=args: savgol_filter_jax(v, *a))(y))

    st = comfort_states()
    out["comfort_in"] = st
    jst = jnp.asarray(st)
    out["comfort"] = {name: np.asarray(jax.jit(fn)(jst)) for name, fn in _comfort_pieces(JC).items()}
    out["comfortable"] = np.asarray(jax.jit(lambda s: JC.ego_is_comfortable(s, np.arange(T) * DT))(jst))
    x = (np.random.default_rng(2).normal(0, 1, 20000) * 10.0 ** np.random.default_rng(3).integers(-9, 2, 20000))
    # and values whose float32 product by 1e8 is an exact half: rounded to even
    k = np.arange(-200, 200) + 0.5
    halves = (k * 1e-8).astype(np.float32)
    halves = halves[(halves * np.float32(1e8)).astype(np.float64) == k]
    assert len(halves) > 20
    out["round8_in"] = np.concatenate([x.astype(np.float32), halves])
    out["round8"] = np.asarray(jax.jit(JC._round8)(out["round8_in"]))

    props = np.concatenate([random_proposals(26, 1), oracle_proposals()])
    out["proposals"] = props
    out["profiles"] = [np.asarray(v) for v in jax.jit(_profiles)(props[..., :3])]
    with jax.enable_x64(True):
        out["profiles64"] = [np.asarray(v) for v in jax.jit(_profiles)(props[..., :3].astype(np.float64))]

    cur, ref, ref_v, curv = lqr_inputs()
    step = functools.partial(JS.lqr_track_step, JS.LQRParams(), jax_pacifica().wheel_base)
    out["lqr"] = [np.asarray(v) for v in jax.jit(step)(cur, ref, ref_v, curv)]
    prop = functools.partial(JS.bicycle_propagate, JS.BicycleParams(), jax_pacifica())
    accel, rate = (np.random.default_rng(4).normal(0, 2, (2, len(cur))).astype(np.float32))
    out["bicycle_cmds"] = (accel, rate)
    out["bicycle"] = np.asarray(jax.jit(lambda s, a, r: prop(s, a, r, DT))(cur, accel, rate))

    # the rollout as `pdm_score` runs it: (scenes, 2 proposals) with one
    # initial state per scene, JAX vmapped over scenes
    scenes = props.reshape(-1, 2, T, S.size())
    init = np.zeros((len(scenes), S.size()), np.float32)
    init[:, S.VELOCITY_X] = np.random.default_rng(5).uniform(0, 12, len(scenes))
    init[:, S.STEERING_ANGLE] = np.random.default_rng(6).normal(0, 0.05, len(scenes))
    out["sim_in"] = (scenes, init)
    sim = JS.PDMSimulator(JaxSampling(num_poses=40, interval_length=DT))
    out["sim"] = np.asarray(jax.jit(jax.vmap(sim.simulate_proposals))(scenes, init))
    with jax.enable_x64(True):
        out["sim64"] = np.asarray(jax.jit(jax.vmap(sim.simulate_proposals))(
            scenes.astype(np.float64), init.astype(np.float64)))
    return out


def _comfort_pieces(C):
    """The comfort module's intermediate signals, by name, for either package."""
    return {
        "lon_acc": lambda s: C._extract_acceleration(s, "x", window_length=T),
        "lat_acc": lambda s: C._extract_acceleration(s, "y", window_length=T),
        "mag_acc": lambda s: C._extract_acceleration(s, "magnitude"),
        "jerk": lambda s: C._round8(C._derivative(C._extract_acceleration(s, "magnitude"), DT, T, 2, 1)),
        "lon_jerk": lambda s: C._round8(C._derivative(C._extract_acceleration(s, "x"), DT, T, 2, 1)),
        "unwrapped": lambda s: C._phase_unwrap(s[..., S.HEADING]),
        "yaw_rate": lambda s: C._round8(C._derivative(C._phase_unwrap(s[..., S.HEADING]), DT, 5, 2, 1)),
        "yaw_accel": lambda s: C._round8(C._derivative(C._phase_unwrap(s[..., S.HEADING]), DT, 5, 3, 2)),
    }


# --------------------------------------------------------------------------- #
# Angles, savgol, comfort
# --------------------------------------------------------------------------- #


def test_normalize_angle_matches_jax(jax_ref):
    got = normalize_angle(t(jax_ref["angles"]), xp=torch).numpy()
    close(got, jax_ref["normalize_angle"], 4 * F32_EPS * np.pi, "normalize_angle")   # measured 2.4e-7
    assert np.abs(got).max() <= np.pi


@pytest.mark.parametrize("args", SAVGOL_ARGS, ids=lambda a: "w{}p{}d{}".format(*a[:3]))
def test_savgol_filter_matches_jax(jax_ref, args):
    got = savgol_filter_torch(t(jax_ref["savgol_in"]), *args)
    want = jax_ref[("savgol", args)]
    assert got.dtype == torch.float32
    close(got.numpy(), want, ulps(want), f"savgol {args}")   # measured <= 1 ulp of max |y|


def test_round8_matches_jax_bit_for_bit(jax_ref):
    """Half to even in float32, and the product by 1e-8 of JAX's jitted
    program (the eager division differs in the last bit)."""
    got = TC._round8(t(jax_ref["round8_in"])).numpy()
    np.testing.assert_array_equal(got, jax_ref["round8"])
    halves = jax_ref["round8_in"][20000:]
    k = np.round((halves * np.float32(1e8)).astype(np.float64) - 0.5) + 0.5
    np.testing.assert_array_equal(np.round(got[20000:] / np.float32(1e-8)), np.round(k / 2) * 2)


@pytest.mark.parametrize("piece", list(_comfort_pieces(TC)))
def test_comfort_signals_elementwise_against_jax(jax_ref, piece):
    got = _comfort_pieces(TC)[piece](t(jax_ref["comfort_in"])).numpy()
    want = jax_ref["comfort"][piece]
    # 1e-5 of max |x|: the yaw rows' products sum 41 unwrapped headings of up
    # to ~16 rad, so their error scales with the input (measured 1.9e-6 of max)
    close(got, want, 1e-5 * max(1.0, np.abs(want).max()), f"comfort {piece}")


def test_comfort_booleans_equal_jax(jax_ref):
    got = TC.ego_is_comfortable(t(jax_ref["comfort_in"]), np.arange(T) * DT).numpy()
    assert got.shape == (16, 6)
    np.testing.assert_array_equal(got, jax_ref["comfortable"])
    assert got.any() and not got.all()


# --------------------------------------------------------------------------- #
# Geometry, on the cases of tests/test_eval_geometry.py
# --------------------------------------------------------------------------- #


def _random_convex_polygon(rng, n=6, scale=5.0, center=(0, 0)):
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(1.0, scale, n)
    return np.stack([center[0] + r * np.cos(angles), center[1] + r * np.sin(angles)], axis=-1)


def _ring(cx, cy, h, length, width):
    c = box_to_corners(np.float32(cx), np.float32(cy), np.float32(h), np.float32(length), np.float32(width))
    return np.concatenate([c, c[..., :1, :]], axis=-2).astype(np.float32)


def test_points_in_polygons_matches_jax_and_mpl():
    rng = np.random.default_rng(0)
    polys = [_random_convex_polygon(rng, n, center=rng.uniform(-10, 10, 2)) for n in (4, 5, 6, 7)]
    angles = np.linspace(0, 2 * np.pi, 10, endpoint=False)
    radii = np.where(np.arange(10) % 2 == 0, 6.0, 2.5)
    polys.append(np.stack([radii * np.cos(angles), radii * np.sin(angles)], axis=-1))
    padded = pad_rings(polys, max_vertices=12)
    points = rng.uniform(-12, 12, size=(300, 2)).astype(np.float32)

    got = TG.points_in_polygons(t(points), t(padded)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JG.points_in_polygons(jnp.asarray(points), jnp.asarray(padded))))
    for p_idx, poly in enumerate(polys):
        assert (got[:, p_idx] == MplPath(poly).contains_points(points)).mean() > 0.99


def test_polygon_predicates_match_jax():
    a = _ring(0, 0, 0.0, 4, 2)
    cases = [(a, _ring(3, 0, 0.0, 4, 2), True), (a, _ring(4, 0, 0.0, 4, 2), True),
             (a, _ring(10, 0, 0.0, 4, 2), False), (a, _ring(0, 0, 0.7, 1, 1), True),
             (_ring(0, 0, 0.7, 1, 1), a, True), (a, _ring(2.9, 2.9, np.pi / 4, 4, 2), True)]
    pa, pb = np.stack([c[0] for c in cases]), np.stack([c[1] for c in cases])
    got = TG.polygons_intersect(t(pa), t(pb)).numpy()
    assert got.tolist() == [c[2] for c in cases]
    np.testing.assert_array_equal(got, np.asarray(JG.polygons_intersect(jnp.asarray(pa), jnp.asarray(pb))))

    poly = _ring(5.0, 0.0, 0.0, 2.0, 2.0)
    s0 = np.array([[0.0, 0.0], [0.0, 5.0], [5.0, 0.0]], np.float32)
    s1 = np.array([[10.0, 0.0], [10.0, 5.0], [20.0, 0.0]], np.float32)
    got = TG.segment_intersects_polygon(t(s0), t(s1), t(poly)[None]).numpy()
    assert got.tolist() == [True, False, True]
    np.testing.assert_array_equal(got, np.asarray(JG.segment_intersects_polygon(
        jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(poly)[None])))

    rng = np.random.default_rng(7)
    seg = rng.integers(-3, 4, (4, 500, 2)).astype(np.float32)   # on a grid: collinear and touching cases
    got = TG.segments_intersect(*map(t, seg)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JG.segments_intersect(*map(jnp.asarray, seg))))
    assert 0.1 < got.mean() < 0.9


def test_batched_intersections_broadcast_match_jax():
    B, Tn, O = 2, 5, 3
    ego = np.stack([np.stack([_ring(ti * 2.0, b * 10.0, 0.0, 4.0, 2.0) for ti in range(Tn)]) for b in range(B)])
    tracks = np.stack([np.stack([_ring(o * 4.0, 0.0, 0.0, 3.0, 2.0) for o in range(O)]) for _ in range(Tn)])
    got = TG.polygons_intersect(t(ego)[:, :, None], t(tracks)[None]).numpy()
    assert got.shape == (B, Tn, O) and got[0].any() and not got[1].any()
    np.testing.assert_array_equal(got, np.asarray(JG.polygons_intersect(jnp.asarray(ego)[:, :, None],
                                                                        jnp.asarray(tracks)[None])))


def test_project_onto_polyline_matches_jax_and_batches():
    line = np.array([[0, 0], [10, 0], [10, 10]], np.float32)
    pts = np.array([[5, 3], [-2, 0], [11, 4], [10, 20]], np.float32)
    got = TG.project_onto_polyline(t(pts), t(line)).numpy()
    np.testing.assert_allclose(got, [5.0, 0.0, 14.0, 20.0], atol=1e-5)
    close(got, np.asarray(JG.project_onto_polyline(jnp.asarray(pts), jnp.asarray(line))), 0.0, "projection")
    # a batch of polylines, (S, 1, L, 2) against points (S, B, 2), equals each alone
    lines = np.stack([line, line[::-1] * 2.0])
    both = TG.project_onto_polyline(t(np.stack([pts, pts])), t(lines)[:, None]).numpy()
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_array_equal(both[1], TG.project_onto_polyline(t(pts), t(lines[1])).numpy())
    assert float(TG.polyline_arclength(t(line))) == pytest.approx(float(JG.polyline_arclength(jnp.asarray(line))))


# --------------------------------------------------------------------------- #
# Simulation
# --------------------------------------------------------------------------- #


def test_profile_fits_match_jax(jax_ref):
    """float32 velocity within 1e-3 m/s and curvature within 1e-5 1/m of
    JAX's (measured 1.0e-4 and 9.5e-7); float64 within 1e-9 (8.0e-14): the
    float32 gap is the conditioning of the normal equations, not the math."""
    poses = t(jax_ref["proposals"][..., :3])
    v, k = TS.velocity_curvature_profiles_from_poses(poses, DT, 1e-4, 1e-2)
    close(v.numpy(), jax_ref["profiles"][0], 1e-3, "velocity f32")
    close(k.numpy(), jax_ref["profiles"][1], 1e-5, "curvature f32")
    v64, k64 = TS.velocity_curvature_profiles_from_poses(poses.double(), DT, 1e-4, 1e-2)
    close(v64.numpy(), jax_ref["profiles64"][0], 1e-9, "velocity f64")
    close(k64.numpy(), jax_ref["profiles64"][1], 1e-9, "curvature f64")
    # the oracle proposals: straight 8 m/s, then the 20 m circle (after its transient)
    np.testing.assert_allclose(v64.numpy()[26], 8.0, atol=0.05)
    np.testing.assert_allclose(k64.numpy()[26], 0.0, atol=0.01)
    np.testing.assert_allclose(v64.numpy()[28], 6.0, atol=0.1)
    np.testing.assert_allclose(k64.numpy()[28, 5:], 1.0 / 20.0, atol=0.01)


def test_solve_spd_gives_nan_where_not_positive_definite():
    """`jnp.linalg.cholesky` gives NaN for a matrix that is not PD; so does
    the port, with no check on the host."""
    spd = np.array([[4.0, 1.0], [1.0, 3.0]], np.float32)
    bad = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)
    rhs = np.ones((2, 2), np.float32)
    got = TS._solve_spd(t(np.stack([spd, bad])), t(rhs)).numpy()
    want = np.asarray(JS._solve_spd(jnp.asarray(np.stack([spd, bad])), jnp.asarray(rhs)))
    np.testing.assert_allclose(got[0], np.linalg.solve(spd, rhs[0]), rtol=1e-6)
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()


def test_lqr_track_step_matches_jax(jax_ref):
    """Closed-form LQR step: accel and steering-rate within 8 float32 ulps of
    max |JAX| (measured within 2); the stopping branch on the same rows."""
    cur, ref, ref_v, curv = lqr_inputs()
    accel, rate = TS.lqr_track_step(TS.LQRParams(), get_pacifica_parameters().wheel_base,
                                    t(cur), t(ref), t(ref_v), t(curv))
    close(accel.numpy(), jax_ref["lqr"][0], ulps(jax_ref["lqr"][0]), "accel")
    close(rate.numpy(), jax_ref["lqr"][1], ulps(jax_ref["lqr"][1]), "steering rate")
    np.testing.assert_array_equal(rate.numpy() == 0.0, jax_ref["lqr"][1] == 0.0)
    assert (rate.numpy() == 0.0).any() and (rate.numpy() != 0.0).any()


def test_bicycle_propagate_matches_jax(jax_ref):
    cur = lqr_inputs()[0]
    accel, rate = jax_ref["bicycle_cmds"]
    got = TS.bicycle_propagate(TS.BicycleParams(), get_pacifica_parameters(), t(cur), t(accel), t(rate), DT)
    want = jax_ref["bicycle"]
    for i in range(S.size()):   # per field: 8 float32 ulps of its max |JAX|
        close(got.numpy()[:, i], want[:, i], ulps(want[:, i]), f"bicycle field {i}")


def test_simulate_proposals_matches_jax_per_scene(jax_ref):
    """(scenes, 2, 41, 11) with one initial state per scene, as `pdm_score`
    runs it: float32 states within 1e-3 after 40 steps (measured 2.0e-5),
    float64 within 1e-9 (2.8e-14)."""
    scenes, init = jax_ref["sim_in"]
    sim = TS.PDMSimulator(SAMPLING)
    got = sim.simulate_proposals(t(scenes), t(init)[:, None])
    assert got.shape == scenes.shape
    close(got.numpy(), jax_ref["sim"], 1e-3, "rollout f32")
    got64 = sim.simulate_proposals(t(scenes).double(), t(init).double()[:, None])
    close(got64.numpy(), jax_ref["sim64"], 1e-9, "rollout f64")
    np.testing.assert_array_equal(got.numpy()[:, :, 0], np.broadcast_to(init[:, None], (len(init), 2, 11)))


def test_simulate_tracks_the_oracle_proposals():
    """`tests/test_simulator.py`'s bounds, from a matched initial state."""
    sim = TS.PDMSimulator(SAMPLING)
    props = oracle_proposals()
    init = np.zeros((len(props), S.size()), np.float32)
    init[:, S.VELOCITY_X] = props[:, 0, S.VELOCITY_X]
    init[5, S.VELOCITY_X] = 5.0
    out = sim.simulate_proposals(t(props), t(init)).numpy()
    assert np.abs(out[1, :, S.X] - props[1, :, S.X]).max() < 0.5 and np.abs(out[1, :, S.Y]).max() < 0.1
    assert np.hypot(*(out[3, :, :2] - props[3, :, :2]).T).max() < 1.0
    assert np.abs(out[4, :, S.VELOCITY_X]).max() < 0.05 and np.abs(out[4, :, S.X]).max() < 0.05
    assert np.hypot(*np.diff(out[5, :, :2], axis=0).T).max() < 2.0 and np.isfinite(out).all()


def _rollout(init, accel_cmd, steer_rate_cmd, n):
    cur = torch.from_numpy(np.asarray(init, np.float64).reshape(1, -1))
    states = [cur]
    for _ in range(n):
        cur = TS.bicycle_propagate(TS.BicycleParams(), get_pacifica_parameters(), cur,
                                   torch.full((1,), accel_cmd, dtype=torch.float64),
                                   torch.full((1,), steer_rate_cmd, dtype=torch.float64), DT)
        states.append(cur)
    return torch.cat(states).numpy()


def test_bicycle_closed_forms():
    """The closed forms of `tests/test_simulator_oracle.py`: constant accel
    command (geometric lag), constant steering (a discrete circle), constant
    steering rate (linear growth)."""
    a, v0, n = 1.5, 3.0, 40
    rho = 0.2 / (DT + 0.2)
    k = np.arange(n + 1)
    init = np.zeros(S.size())
    init[S.VELOCITY_X] = v0
    out = _rollout(init, a, 0.0, n)
    v_k = v0 + a * DT * (k - rho * (1.0 - rho ** k) / (1.0 - rho))
    np.testing.assert_allclose(out[:, S.ACCELERATION_X], a * (1.0 - rho ** k), atol=1e-5)
    np.testing.assert_allclose(out[:, S.VELOCITY_X], v_k, atol=1e-4)
    np.testing.assert_allclose(out[:, S.X], np.concatenate([[0.0], np.cumsum(v_k[:-1]) * DT]), atol=1e-4)

    v, delta = 5.0, 0.12
    phi = v * np.tan(delta) / get_pacifica_parameters().wheel_base * DT
    init = np.zeros(S.size())
    init[S.VELOCITY_X], init[S.STEERING_ANGLE] = v, delta
    out = _rollout(init, 0.0, 0.0, n)
    np.testing.assert_allclose(out[:, S.HEADING], ((k * phi + np.pi) % (2 * np.pi)) - np.pi, atol=1e-5)
    z = np.exp(1j * phi)
    pos = v * DT * (z ** k - 1.0) / (z - 1.0)
    np.testing.assert_allclose(out[:, S.X], pos.real, atol=1e-4)
    np.testing.assert_allclose(out[:, S.Y], pos.imag, atol=1e-4)

    r, n = 0.2, 20
    out = _rollout(np.zeros(S.size()), 0.0, r, n)
    gain = DT / (DT + 0.05)
    np.testing.assert_allclose(out[:, S.STEERING_ANGLE], gain * r * DT * np.arange(n + 1), atol=1e-6)
    np.testing.assert_allclose(out[1:, S.STEERING_RATE], gain * r, atol=1e-6)
