"""The port's matchers (ops/matching.py, ops/match_scan.py) against the JAX package's.

On the CPU the port's ``search_for_initialization`` runs the plain dense
scan; it must be bit-identical to the JAX package's XLA path and to the
Pallas kernel ``fused_search_for_initialization`` in interpret mode (the
distances are exact integers and the window test rounds the same ops), on
the cases of tests/test_pallas_matching.py, on ties and on empty rows. The
four other matchers, ``essential_from_pose`` and ``epipolar_inliers`` are held
to JAX on the same inputs (matches exact; E to 1e-6). The CUDA kernel is
held to the plain version only on a card (marked ``cuda``; it skips here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pallas_matching import _random_problem
from triangulation_in_deformable_scenes_torch.ops import match_scan as TS
from triangulation_in_deformable_scenes_torch.ops import matching as TM
from triangulation_in_deformable_scenes_tpu.ops import matching as JM
from triangulation_in_deformable_scenes_tpu.ops import pallas_kernels as JP

torch.set_num_threads(1)

KW = dict(th=60.0, window_factor=30.0, ratio=0.9, max_octave=3)


def _torch_args(args, device="cpu"):
    kp1, d1, o1, v1, kp2, d2, o2, v2, sf = args
    t = lambda x, dt=None: torch.as_tensor(np.array(x), device=device, dtype=dt)
    return (t(kp1, torch.float32), t(d1, torch.uint8), t(o1, torch.int32), t(v1), t(kp2, torch.float32),
            t(d2, torch.uint8), t(o2, torch.int32), t(v2), t(sf, torch.float32))


def _jax_args(args):
    return tuple(jnp.asarray(a) for a in args)


def _tie_problem():
    """Duplicated columns (the best is attained twice: the first occurrence
    must win and the second-best equals the best), two rows that claim one
    column at an equal distance, and keys on the window's circle."""
    rng = np.random.default_rng(11)
    n1, n2 = 40, 60
    kp1 = rng.uniform(0, 200, size=(n1, 2)).astype(np.float32)
    kp2 = rng.uniform(0, 200, size=(n2, 2)).astype(np.float32)
    d1 = rng.integers(0, 2, size=(n1, 256)).astype(np.int8)
    d2 = rng.integers(0, 2, size=(n2, 256)).astype(np.int8)
    for i in range(10):  # columns 2i and 2i+1 both equal row i's descriptor
        d2[2 * i] = d1[i]
        d2[2 * i + 1] = d1[i]
        kp2[2 * i] = kp1[i] + 1.0
        kp2[2 * i + 1] = kp1[i] - 1.0
    d1[20] = d1[21]  # rows 20 and 21 claim column 30 at the same distance
    d2[30] = d1[20]
    kp1[21] = kp1[20]
    kp2[30] = kp1[20] + 2.0
    kp2[31] = kp1[22] + np.float32([3.0, 4.0])  # exactly on a radius-5 circle
    d2[31] = d1[22]
    o1 = np.zeros(n1, np.int32)
    o2 = np.zeros(n2, np.int32)
    v1 = np.ones(n1, bool)
    v2 = np.ones(n2, bool)
    sf = np.array([1.2**o for o in range(4)], dtype=np.float32)
    return kp1, d1, o1, v1, kp2, d2, o2, v2, sf


def _lane_tie_problem():
    """Ties that the CUDA kernel's lanes (lane l scans the columns j = l mod
    32) must merge by column: rows whose best (distance 0) is attained at
    columns (10, 11), (40, 72), (8, 33) where the higher lane holds the
    lower column, (63, 64) and (255, 256) across lanes and 256-column tiles,
    (5, 261) in one lane across tiles, (3, 34, 65) three ways; rows whose
    second best ties in two lanes; rows far from every column; 611 columns,
    a multiple of neither 32 nor 256."""
    rng = np.random.default_rng(12)
    n1, n2 = 64, 611
    kp1 = rng.uniform(0, 600, size=(n1, 2)).astype(np.float32)
    kp2 = rng.uniform(0, 600, size=(n2, 2)).astype(np.float32)
    d1 = rng.integers(0, 2, size=(n1, 256)).astype(np.int8)
    d2 = rng.integers(0, 2, size=(n2, 256)).astype(np.int8)
    ties = [(10, 11), (40, 72), (8, 33), (63, 64), (255, 256), (5, 261), (3, 34, 65), (100, 395), (600, 610)]
    for i, cols in enumerate(ties):
        for k, j in enumerate(cols):
            d2[j] = d1[i]
            kp2[j] = kp1[i] + np.float32(0.5 * (k + 1))
    for i, (j0, j1, j2) in enumerate([(120, 150, 151), (200, 231, 230)], start=len(ties)):
        d2[j0] = d1[i]
        kp2[j0] = kp1[i] + 0.5
        for j in (j1, j2):
            d2[j] = d1[i]
            d2[j, :3] ^= 1
            kp2[j] = kp1[i] - 0.5
    kp1[40:50] = 5000.0
    v1 = np.ones(n1, bool)
    v1[50:54] = False
    sf = np.array([1.2**o for o in range(4)], dtype=np.float32)
    return kp1, d1, np.zeros(n1, np.int32), v1, kp2, d2, np.zeros(n2, np.int32), np.ones(n2, bool), sf


CASES = {
    "random_128x128": lambda: _random_problem(np.random.default_rng(128 * 1000 + 128), 128, 128),
    "random_200x330": lambda: _random_problem(np.random.default_rng(200 * 1000 + 330), 200, 330),
    "random_100x513": lambda: _random_problem(np.random.default_rng(100 * 1000 + 513), 100, 513),
    "ties": _tie_problem,
    "lane_ties": _lane_tie_problem,
}
WINDOW_5 = ("ties", "lane_ties")  # cases on a radius-5 window


def _empty_rows():
    args = list(_random_problem(np.random.default_rng(7), 64, 64))
    args[3] = np.zeros_like(args[3])
    return tuple(args)


@pytest.mark.parametrize("case", list(CASES) + ["empty_rows"])
def test_plain_bit_identical_to_xla_and_pallas(case):
    args = _empty_rows() if case == "empty_rows" else CASES[case]()
    kw = dict(KW, window_factor=5.0) if case in WINDOW_5 else KW
    m_x, n_x = JM.search_for_initialization(*_jax_args(args), backend="xla", **kw)
    m_p, n_p = JP.fused_search_for_initialization(*_jax_args(args), interpret=True, **kw)
    m_t, n_t = TM.search_for_initialization(*_torch_args(args), **kw)
    assert m_t.dtype == torch.int32
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_x))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_p))
    assert int(n_t) == int(n_x) == int(n_p)
    if case == "empty_rows":
        assert int(n_t) == 0 and (m_t.numpy() == -1).all()
    else:
        assert int(n_t) > 0


def _pallas_scan(args, window_factor, max_octave):
    """(best_d, best, second_d) of the Pallas scan in interpret mode, built
    as fused_search_for_initialization builds its inputs."""
    kp1, d1, o1, v1, kp2, d2, o2, v2, sf = _jax_args(args)
    tm = JP.TILE_M
    n1, n2 = kp1.shape[0], kp2.shape[0]
    n1p, n2p = -(-n1 // tm) * tm, -(-n2 // tm) * tm
    radius = window_factor * sf[jnp.clip(o1, 0, len(sf) - 1)]
    rm = jnp.zeros((n1p, 8), jnp.float32).at[:n1, 0].set(kp1[:, 0]).at[:n1, 1].set(kp1[:, 1])
    rm = rm.at[:n1, 2].set(radius**2).at[:n1, 3].set(o1.astype(jnp.float32))
    rm = rm.at[:n1, 4].set(((o1 <= max_octave) & v1).astype(jnp.float32))
    cm = jnp.zeros((n2p, 8), jnp.float32).at[:n2, 0].set(kp2[:, 0]).at[:n2, 1].set(kp2[:, 1])
    cm = cm.at[:n2, 2].set(o2.astype(jnp.float32)).at[:n2, 3].set(v2.astype(jnp.float32))
    out = JP._match_scan(rm, cm, JP._pad_rows(d1.astype(jnp.int8), n1p), JP._pad_rows(d2.astype(jnp.int8), n2p),
                         interpret=True)
    return tuple(np.asarray(o)[:n1] for o in out)


@pytest.mark.parametrize("case", ["random_200x330", "ties", "lane_ties"])
def test_plain_scan_outputs_match_pallas_scan(case):
    """best_d, the first-occurrence argmin and second_d themselves, not only
    the matches they lead to; on the tie cases some rows have second == best."""
    args = CASES[case]()
    wf = 5.0 if case in WINDOW_5 else KW["window_factor"]
    want = _pallas_scan(args, wf, KW["max_octave"])
    kp1, d1, o1, v1, kp2, d2, o2, v2, sf = _torch_args(args)
    r2, row_ok = TS.row_meta(kp1, o1, v1, sf, wf, KW["max_octave"])
    got = TS.match_scan_plain(kp1, r2, o1, row_ok, d1, kp2, o2, v2, d2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    bd, b, sd = (g.numpy() for g in got)
    if case == "ties":
        np.testing.assert_array_equal(b[:10], 2 * np.arange(10))
        assert (bd[:10] == 0).all() and (sd[:10] == 0).all()
    if case == "lane_ties":
        np.testing.assert_array_equal(b[:11], [10, 40, 8, 63, 255, 5, 3, 100, 600, 120, 200])
        assert (bd[:11] == 0).all() and (sd[:9] == 0).all() and (sd[9:11] == 3).all()
        assert (bd[40:54] == TS.BIG).all() and (b[40:54] == 0).all()


def test_one_to_one_keeps_equal_distance_conflicts():
    """JAX's `<=` (matching.py:141): two rows at an equal best distance to one
    column both keep it."""
    best = torch.tensor([3, 3, 1, 3])
    best_d = torch.tensor([5.0, 5.0, 2.0, 7.0])
    ok = torch.tensor([True, True, True, True])
    m, n = TM._one_to_one(best, best_d, ok, 4)
    jm, jn = JM._one_to_one(jnp.asarray(best.numpy()), jnp.asarray(best_d.numpy()), jnp.asarray(ok.numpy()), 4)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(m.numpy(), [3, 3, 1, -1])
    assert int(n) == int(jn) == 3


def test_hamming_matrix_exact():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2, size=(40, 256)).astype(np.uint8)
    b = rng.integers(0, 2, size=(50, 256)).astype(np.uint8)
    D = TM.hamming_matrix(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(D, (a[:, None, :] != b[None, :, :]).sum(-1))


def test_pack_bits_layout():
    rng = np.random.default_rng(5)
    d = rng.integers(0, 2, size=(7, 256)).astype(np.uint8)
    words = TS.pack_bits(torch.as_tensor(d)).numpy().view(np.uint32)
    want = np.packbits(d.reshape(7, 8, 32)[:, :, ::-1], axis=-1, bitorder="big").view(">u4")[..., 0]
    np.testing.assert_array_equal(words, want.astype(np.uint32))


def _mp_problem(seed=21, n1=80, n2=150):
    rng = np.random.default_rng(seed)
    kp1, d1, o1, v1, kp2, d2, o2, v2, sf = _random_problem(rng, n1, n2, spread=300.0)
    return kp1, d1, o1, v1, kp2, d2, o2, v2, sf, rng


def test_guided_matching_matches_jax():
    kp1, d1, o1, v1, kp2, d2, o2, v2, sf, _ = _mp_problem()
    a = (kp1, d1, o1, v1, kp2, d2, o2, v2, sf)
    kw = dict(th=60.0, window_factor=2.0, ratio=0.9)
    jm, jn = JM.guided_matching(*_jax_args(a), **kw)
    tm, tn = TM.guided_matching(*_torch_args(a), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tn) == int(jn) > 0


def test_search_with_projection_matches_jax():
    kp1, d1, o1, v1, kp2, d2, o2, v2, sf, rng = _mp_problem(22)
    n1 = len(kp1)
    view_cos = rng.uniform(0.3, 1.0, n1).astype(np.float32)
    view_cos[:10] = 0.9995
    dist = rng.uniform(0.5, 3.0, n1).astype(np.float32)
    dmin = (dist * rng.uniform(0.5, 1.05, n1)).astype(np.float32)
    dmax = (dist * rng.uniform(0.95, 4.0, n1)).astype(np.float32)
    kw = dict(th=100.0, ratio=0.9)
    jm, jn = JM.search_with_projection(
        jnp.asarray(kp1), jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(view_cos), jnp.asarray(dist),
        jnp.asarray(dmin), jnp.asarray(dmax), jnp.asarray(kp2), jnp.asarray(d2), jnp.asarray(o2),
        jnp.asarray(v2), jnp.asarray(sf), **kw)
    T = lambda x: torch.as_tensor(np.array(x))
    tm, tn = TM.search_with_projection(
        T(kp1), T(d1).to(torch.uint8), T(v1), T(view_cos), T(dist), T(dmin), T(dmax), T(kp2),
        T(d2).to(torch.uint8), T(o2), T(v2), T(sf), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tn) == int(jn) > 0


def _rays(rng, n, t):
    pts = rng.normal(size=(n, 3)) * [0.3, 0.3, 0.1] + [0, 0, 1.5]
    r1 = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    p2 = pts - t
    r2 = p2 / np.linalg.norm(p2, axis=-1, keepdims=True)
    return r1.astype(np.float32), r2.astype(np.float32)


def test_search_for_triangulation_matches_jax():
    rng = np.random.default_rng(23)
    n = 90
    t = np.array([0.1, 0.02, 0.0])
    r1, r2 = _rays(rng, n, t)
    perm = rng.permutation(n)
    r2 = r2[perm]
    d1 = rng.integers(0, 2, size=(n, 256)).astype(np.int8)
    d2 = d1[perm].copy()
    flip = rng.integers(0, 256, size=(n, 6))
    for i in range(n):
        d2[i, flip[i]] ^= 1
    free1 = rng.uniform(size=n) > 0.1
    free2 = rng.uniform(size=n) > 0.1
    E = np.asarray(JM.essential_from_pose(jnp.eye(3), jnp.asarray(-t, jnp.float32)))
    kw = dict(th=50.0, epipolar_th=0.01)
    jm, jn = JM.search_for_triangulation(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(r1), jnp.asarray(r2),
                                         jnp.asarray(E), jnp.asarray(free1), jnp.asarray(free2), **kw)
    T = lambda x: torch.as_tensor(np.array(x))
    tm, tn = TM.search_for_triangulation(T(d1).to(torch.uint8), T(d2).to(torch.uint8), T(r1), T(r2), T(E),
                                         T(free1), T(free2), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tn) == int(jn) > 0


def test_fuse_matching_matches_jax():
    kp1, d1, o1, v1, kp2, d2, o2, v2, sf, _ = _mp_problem(24)
    a = (kp1, d1, o1, v1, kp2, d2, o2, v2, sf)
    kw = dict(th=60.0, ratio=0.9)
    jm, jn = JM.fuse_matching(*_jax_args(a), **kw)
    tm, tn = TM.fuse_matching(*_torch_args(a), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tn) == int(jn) > 0


def test_essential_and_epipolar_inliers_match_jax():
    rng = np.random.default_rng(25)
    w = rng.normal(size=3) * 0.05
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = (np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th**2 * W @ W).astype(np.float32)
    t = np.array([0.1, -0.03, 0.02], np.float32)
    Ej = np.asarray(JM.essential_from_pose(jnp.asarray(R), jnp.asarray(t)))
    Et = TM.essential_from_pose(torch.as_tensor(R), torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(Et, Ej, rtol=0, atol=1e-6)
    r1, r2 = _rays(rng, 200, np.array([0.1, 0.0, 0.0]))
    r2[:60] = r2[:60][:, [1, 0, 2]]
    E = np.asarray(JM.essential_from_pose(jnp.eye(3), jnp.asarray([-0.1, 0.0, 0.0])))
    want = np.asarray(JM.epipolar_inliers(jnp.asarray(E), jnp.asarray(r1), jnp.asarray(r2), 0.002))
    got = TM.epipolar_inliers(torch.as_tensor(E), torch.as_tensor(r1), torch.as_tensor(r2), 0.002).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.3 < want.mean() < 0.9


def test_match_scan_cuda_rejects_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only: a CPU tensor raises
    instead of falling back to the plain version."""
    kp1, d1, o1, v1, kp2, d2, o2, v2, sf = _torch_args(CASES["random_128x128"]())
    r2, row_ok = TS.row_meta(kp1, o1, v1, sf, 30.0, 3)
    with pytest.raises(ValueError):
        TS.match_scan_cuda(kp1, r2, o1, row_ok, d1, kp2, o2, v2, d2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES) + ["empty_rows"])
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    args = _empty_rows() if case == "empty_rows" else CASES[case]()
    wf = 5.0 if case in WINDOW_5 else KW["window_factor"]
    kp1, d1, o1, v1, kp2, d2, o2, v2, sf = _torch_args(args, device="cuda")
    r2, row_ok = TS.row_meta(kp1, o1, v1, sf, wf, KW["max_octave"])
    before = TS.LAUNCHES
    got = TS.match_scan(kp1, r2, o1, row_ok, d1, kp2, o2, v2, d2)
    torch.cuda.synchronize()
    assert TS.LAUNCHES == before + 1
    want = TS.match_scan_plain(kp1, r2, o1, row_ok, d1, kp2, o2, v2, d2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for _ in range(20):
        assert all(torch.equal(g, w) for g, w in zip(TS.match_scan_cuda(kp1, r2, o1, row_ok, d1, kp2, o2, v2, d2), want))
