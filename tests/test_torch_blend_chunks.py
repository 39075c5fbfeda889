"""The chunked blend of the CUDA kernels, held on the CPU: the work list
(ops/blend_cuda.py chunk_work_list), and a plain chunked composition
written out here with the kernels' split rule, pass A, pass B and merge
against the sequential plain versions (blend_forward_torch,
blend_backward_torch).

The composition runs with a small test-only chunk (C = 16) on
tests/torch_chunk_fixtures.py's long-segment slab, whose tiles split into
several chunks and where some pixels saturate inside a chunk and some on
the first key of a later chunk. Floats at rtol 2e-3 / atol 1e-4 (the chunked
transmittance is the sequential one in another rounding order), `last` and
`count` as counts (tests/torch_port_fixtures.py)."""

import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
from taichi_3d_gaussian_splatting_torch.ops.gaussian import (
    ALPHA_SKIP_THRESHOLD)

from torch_chunk_fixtures import (NUM_TILES, OPS_CONTRIBUTING,
                                  OPS_SATURATING, OPS_SKIPPED, TILES_PER_ROW,
                                  long_segment_slab, pair_counts, work)
from torch_port_fixtures import ATOL, COVERED_ALPHA, RTOL, assert_counts_close

torch.set_num_threads(1)
C = 16
KW = dict(num_tiles=NUM_TILES, tiles_per_row=TILES_PER_ROW)
SAT = BC.TRANSMITTANCE_SATURATION


def _items(starts, ends, mk, chunk):
    """(work list, its valid items as (index, tile, start, end, j, n)
    tuples, as the kernels expand them)."""
    work = BC.chunk_work_list(starts, ends, mk, chunk)
    items = work.items
    assert items.dtype == torch.int32
    assert tuple(items.shape) == (5, work.num_items)
    return work, [(i,) + tuple(items[:, i].tolist())
                  for i in range(work.num_items) if int(items[0, i]) >= 0]


@pytest.mark.parametrize("chunk", [4, 16])
def test_chunk_work_list_covers_each_range_once_in_order(chunk):
    lengths = [0, 1, chunk, chunk + 1, 3 * chunk + 7, 0, chunk - 1,
               2 * chunk]
    ends = torch.tensor(np.cumsum(lengths), dtype=torch.int32)
    starts = ends - torch.tensor(lengths, dtype=torch.int32)
    mk = int(ends[-1]) + 5
    work, items = _items(starts, ends, mk, chunk)
    seen = {}
    for i, tile, lo, hi, j, n in items:
        seen.setdefault(tile, []).append((i, lo, hi, j, n))
    assert sorted(seen) == list(range(len(lengths)))
    split_items = 0
    for tile, its in seen.items():
        n = max(1, -(-lengths[tile] // chunk))
        assert len(its) == n and all(x[4] == n for x in its)
        # consecutive items, chunk indices 0..n-1, ranges that tile the
        # segment in order, each at most `chunk` keys
        assert [x[0] for x in its] == list(range(its[0][0], its[0][0] + n))
        assert [x[3] for x in its] == list(range(n))
        assert its[0][1] == int(starts[tile]) and its[-1][2] == int(ends[tile])
        assert all(a[2] == b[1] for a, b in zip(its, its[1:]))
        assert all(0 <= x[2] - x[1] <= chunk for x in its)
        if n > 1:
            split_items += n
            assert max(x[0] for x in its) < work.num_split_items
    # split tiles first, each group in tile order; the split tiles' items
    # within the host bound
    split = [tile for tile in seen if len(seen[tile]) > 1]
    order = sorted(seen, key=lambda t: seen[t][0][0])
    assert order == sorted(split) + sorted(set(seen) - set(split))
    assert split_items <= work.num_split_items


def test_chunk_work_list_clamps_malformed_ranges():
    starts = torch.tensor([-5, 3, 9], dtype=torch.int32)
    ends = torch.tensor([2, 40, 4], dtype=torch.int32)
    _, items = _items(starts, ends, 10, 4)
    got = {(tile, lo, hi) for _, tile, lo, hi, _, _ in items}
    assert got == {(0, 0, 2), (1, 3, 7), (1, 7, 10), (2, 9, 9)}


def _alpha(cols, c, px, py):
    u, v, ca, cb, cc, logw = (x[c] for x in cols[:6])
    dx, dy = px - u, py - v
    return torch.exp(-0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
                     + logw), dx, dy


def _chunk_transmittance(cols, px, py, lo, hi):
    """Pass A: prod (1 - min(alpha, 0.99)) over the non-skipped keys,
    stopping once it falls below 1e-4."""
    T = torch.ones_like(px)
    for c in range(lo, hi):
        a, _, _ = _alpha(cols, c, px, py)
        live = (a >= ALPHA_SKIP_THRESHOLD) & (T >= SAT)
        T = torch.where(live, T * (1 - a.clamp(max=BC.ALPHA_CLAMP)), T)
    return T


# what a chunk did to a pixel (csrc/blend_forward.cu ChunkState)
RAN_THROUGH, SATURATED_HERE, STARTED_SATURATED = 0, 1, 2


def _blend_chunk(cols, px, py, lo, hi, T):
    """Pass B: blend [lo, hi) from T_in; returns the partials, T at the
    end, the chunk's state and the column where each pixel saturated
    (-1)."""
    active = T >= SAT
    done = ~active
    acc = torch.zeros((5,) + px.shape)
    last = torch.zeros_like(px)
    count = torch.zeros_like(px)
    sat_col = torch.full(px.shape, -1)
    for c in range(lo, hi):
        a, _, _ = _alpha(cols, c, px, py)
        live = ~done & (a >= ALPHA_SKIP_THRESHOLD)
        a = a.clamp(max=BC.ALPHA_CLAMP)
        t_next = T * (1 - a)
        sat = live & (t_next < SAT)
        contrib = live & ~sat
        sat_col = torch.where(sat, c, sat_col)
        done = done | sat
        w = torch.where(contrib, a * T, 0.0)
        acc += w * torch.stack([cols[6][c], cols[7][c], cols[8][c],
                                torch.tensor(1.0), cols[9][c]])[:, None]
        last = torch.where(contrib, float(c + 1), last)
        count += contrib.float()
        T = torch.where(contrib, t_next, T)
    state = torch.where(~active, STARTED_SATURATED,
                        torch.where(done, SATURATED_HERE, RAN_THROUGH))
    return acc, last, count, T, state, sat_col


def _chunked_forward(slab, starts, ends, rgb_only, chunk, edge=False,
                     stop=True):
    """The kernels' chunked forward, plainly: (out like blend_forward_torch,
    per pixel the saturating key's position in its segment, or -1).

    With `edge`, a pixel that saturated in an earlier chunk starts the next
    chunk at T_in = 1e-4, as where the product of the T_chunk rounds up to
    the edge. Such a chunk saturates the pixel at its first non-skipped key
    and blends nothing, but its T is not the pixel's: the merge (with
    `stop`, as the kernel does) takes T from the chunk where the pixel
    saturated."""
    cols = BC._slab_columns(slab)
    _, items = _items(starts, ends, slab.shape[1], chunk)
    px, py = BC._pixel_centres(NUM_TILES, TILES_PER_ROW, "cpu")
    tchunk = {i: _chunk_transmittance(cols, px[t], py[t], lo, hi)
              for i, t, lo, hi, j, n in items if n > 1 and j < n - 1}
    parts = {}
    for i, t, lo, hi, j, n in items:
        T = torch.ones(BC.PIXELS_PER_TILE)
        for k in range(i - j, i):
            T = T * tchunk[k]
        if edge and j > 0:
            earlier = torch.stack([p[4] for p in parts[t]])
            T = torch.where((earlier == SATURATED_HERE).any(0), SAT, T)
        parts.setdefault(t, []).append(
            _blend_chunk(cols, px[t], py[t], lo, hi, T))
    out = torch.zeros((NUM_TILES, 8, BC.PIXELS_PER_TILE))
    sat_pos = torch.full((NUM_TILES, BC.PIXELS_PER_TILE), -1)
    for t, chunks in parts.items():                 # merge in chunk order
        T = torch.ones(BC.PIXELS_PER_TILE)
        stopped = torch.zeros(BC.PIXELS_PER_TILE, dtype=torch.bool)
        for acc, last, count, t_end, state, sat_col in chunks:
            take = ~stopped & (state != STARTED_SATURATED)
            if stop:
                stopped |= state != RAN_THROUGH
            else:
                take = torch.ones_like(take)
            out[t, [BC.OUT_R, BC.OUT_G, BC.OUT_B, BC.OUT_NORM]] += torch.where(
                take, acc[:4], 0.0)
            out[t, BC.OUT_DEPTH] += torch.where(take, acc[4], 0.0)
            out[t, BC.OUT_LAST_EFF] = torch.where(take, torch.maximum(
                out[t, BC.OUT_LAST_EFF], last), out[t, BC.OUT_LAST_EFF])
            out[t, BC.OUT_COUNT] += torch.where(take, count, 0.0)
            T = torch.where(take & (state != STARTED_SATURATED), t_end, T)
            sat_pos[t] = torch.where(take & (sat_col >= 0),
                                     sat_col - int(starts[t]), sat_pos[t])
        out[t, BC.OUT_DEPTH] /= out[t, BC.OUT_NORM].clamp(min=1e-6)
        out[t, BC.OUT_ACC_ALPHA] = 1 - T
    if rgb_only:
        out[:, [BC.OUT_DEPTH, BC.OUT_LAST_EFF, BC.OUT_COUNT]] = 0
    return out, sat_pos


def _compare_forward(got, ref, rgb_only):
    for row in (BC.OUT_R, BC.OUT_G, BC.OUT_B, BC.OUT_ACC_ALPHA, BC.OUT_NORM):
        np.testing.assert_allclose(got[:, row], ref[:, row], rtol=RTOL,
                                   atol=ATOL, err_msg=f"row {row}")
    if rgb_only:
        assert not got[:, [BC.OUT_DEPTH, BC.OUT_LAST_EFF, BC.OUT_COUNT]].any()
        return
    covered = ref[:, BC.OUT_ACC_ALPHA] > COVERED_ALPHA
    np.testing.assert_allclose(got[:, BC.OUT_DEPTH][covered],
                               ref[:, BC.OUT_DEPTH][covered], rtol=RTOL,
                               atol=ATOL, err_msg="depth")
    for row in (BC.OUT_LAST_EFF, BC.OUT_COUNT):
        assert_counts_close(ref[:, row], got[:, row], f"row {row}")


@pytest.mark.parametrize("fmt, rgb_only", [("packed8", True),
                                           ("wide16", True),
                                           ("wide16", False)])
def test_chunked_forward_matches_plain(fmt, rgb_only):
    slabs, starts, ends = long_segment_slab(C)
    slab = slabs[fmt]
    got, sat_pos = _chunked_forward(slab, starts, ends, rgb_only, C)
    ref = BC.blend_forward_torch(slab, starts, ends, rgb_only=rgb_only, **KW)
    _compare_forward(got.numpy(), ref.numpy(), rgb_only)
    # the fixture saturates pixels inside a chunk and on a later chunk's
    # first key, in the chunked and in the sequential blend alike
    sat = sat_pos[sat_pos >= 0]
    assert (sat % C != 0).any() and ((sat % C == 0) & (sat > 0)).any()
    seq_sat = pair_counts(slabs["wide16"], starts, ends, **KW)["sat_pos"]
    assert ((seq_sat % C == 0) & (seq_sat > 0)).any()
    # an empty tile writes zeros
    assert not got[3].any() and not ref[3].any()


def test_chunked_merge_stops_where_the_pixel_saturated():
    """A pixel that saturated in chunk j but starts chunk j + 1 at T_in >=
    1e-4 (rounding at the edge): the merge stops after chunk j, so the
    pixel ends with the T before its saturating key, as in the sequential
    blend, and `last` and `count` are the sequential ones (K3's keys below
    `last` are the keys the forward blended)."""
    slabs, starts, ends = long_segment_slab(C)
    slab = slabs["wide16"]
    ref = BC.blend_forward_torch(slab, starts, ends, rgb_only=False, **KW)
    got, sat_pos = _chunked_forward(slab, starts, ends, False, C, edge=True)
    _compare_forward(got.numpy(), ref.numpy(), False)
    for row in (BC.OUT_LAST_EFF, BC.OUT_COUNT):
        assert torch.equal(got[:, row], ref[:, row])
    last = got[:, BC.OUT_LAST_EFF] - starts[:, None]
    sat = sat_pos >= 0
    assert (sat_pos[sat] >= last[sat]).all()
    acc = BC.OUT_ACC_ALPHA
    assert float((got[:, acc] - ref[:, acc]).abs().max()) < 1e-6
    # a merge that took T from the later chunks would end such pixels at
    # T_in ~ 1e-4 instead
    loose, _ = _chunked_forward(slab, starts, ends, False, C, edge=True,
                                stop=False)
    assert float((loose[:, acc] - ref[:, acc]).abs().max()) > 1e-4


def _chunked_backward(slab, starts, ends, pixel_in, chunk):
    """The kernels' chunked backward, plainly: pass A (T_chunk, Q_chunk)
    from (1, 0), pass B from (T_in, P_in), the magnitude image merged in
    chunk order; returns what blend_backward_torch returns."""
    cols = BC._slab_columns(slab)
    mk = slab.shape[1]
    _, items = _items(starts, ends, mk, chunk)
    px, py = BC._pixel_centres(NUM_TILES, TILES_PER_ROW, "cpu")
    g = pixel_in[:, 0:3]
    S = (g * pixel_in[:, 3:6]).sum(1)
    last = pixel_in[:, BC.PIXEL_IN_LAST]
    grad = torch.zeros((BC.NUM_DATA_ROWS, mk))
    mag = torch.zeros((NUM_TILES, 8, BC.PIXELS_PER_TILE))

    def replay(t, lo, hi, T, P, write):
        m = torch.zeros((2, BC.PIXELS_PER_TILE))
        Q = torch.zeros_like(T)
        for c in range(lo, hi):
            a_exp, dx, dy = _alpha(cols, c, px[t], py[t])
            contrib = (a_exp >= ALPHA_SKIP_THRESHOLD) & (c < last[t])
            a = a_exp.clamp(max=BC.ALPHA_CLAMP)
            cg = cols[6][c] * g[t, 0] + cols[7][c] * g[t, 1] + cols[8][c] * g[t, 2]
            w = torch.where(contrib, a * T, 0.0)
            Q = Q + w * cg
            P = P + w * cg
            G = torch.where(contrib, (cg * T - (S[t] - P) / (1 - a)) * a_exp,
                            0.0)
            gx = G * (cols[2][c] * dx + cols[3][c] * dy)
            gy = G * (cols[4][c] * dy + cols[3][c] * dx)
            if write:
                grad[list(BC.GRAD_ROWS), c] = torch.stack([
                    gx, gy, -0.5 * G * dx * dx, -G * dx * dy,
                    -0.5 * G * dy * dy, G, g[t, 0] * w, g[t, 1] * w,
                    g[t, 2] * w, torch.sqrt(gx * gx + gy * gy),
                    contrib.float()]).sum(1)
            m += torch.stack([gx.abs(), gy.abs()])
            T = torch.where(contrib, T * (1 - a), T)
        return T, Q, m

    tq = {}
    for i, t, lo, hi, j, n in items:                 # pass A
        if n > 1 and j < n - 1:
            T, Q, _ = replay(t, lo, hi, torch.ones(BC.PIXELS_PER_TILE),
                             torch.zeros(BC.PIXELS_PER_TILE), False)
            tq[i] = (T, Q)
    for i, t, lo, hi, j, n in items:                 # pass B, then merge
        T = torch.ones(BC.PIXELS_PER_TILE)
        P = torch.zeros(BC.PIXELS_PER_TILE)
        for k in range(i - j, i):
            P = P + T * tq[k][1]
            T = T * tq[k][0]
        _, _, m = replay(t, lo, hi, T, P, True)
        mag[t, 0:2] += m
    return grad, mag


def test_chunked_backward_matches_plain():
    slabs, starts, ends = long_segment_slab(C)
    slab = slabs["wide16"]
    fwd = BC.blend_forward_torch(slab, starts, ends, rgb_only=False, **KW)
    rng = np.random.default_rng(5)
    pixel_in = torch.zeros((NUM_TILES, 8, BC.PIXELS_PER_TILE))
    pixel_in[:, 0:3] = torch.as_tensor(rng.normal(
        size=(NUM_TILES, 3, BC.PIXELS_PER_TILE)).astype(np.float32))
    pixel_in[:, 3:6] = fwd[:, 0:3]
    pixel_in[:, BC.PIXEL_IN_LAST] = fwd[:, BC.OUT_LAST_EFF]
    got = _chunked_backward(slab, starts, ends, pixel_in, C)
    ref = BC.blend_backward_torch(slab, starts, ends, pixel_in, **KW)
    float_rows = [r for r in BC.GRAD_ROWS if r != BC.GROW_NUM_PIXELS]
    np.testing.assert_allclose(got[0][float_rows], ref[0][float_rows],
                               rtol=RTOL, atol=ATOL)
    # the pixel counts are exact: both take K2's `last`, not a re-test
    assert torch.equal(got[0][BC.GROW_NUM_PIXELS], ref[0][BC.GROW_NUM_PIXELS])
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL, atol=ATOL)
    assert ref[0][float_rows].abs().max() > 0


def test_backward_blends_the_keys_below_last():
    """blend_backward_torch takes the forward's `last`: with row 6 at 0 no
    key contributes; with the forward's row its pixel counts equal the
    forward's count per tile."""
    slabs, starts, ends = long_segment_slab(C)
    slab = slabs["wide16"]
    fwd = BC.blend_forward_torch(slab, starts, ends, rgb_only=False, **KW)
    pixel_in = torch.zeros((NUM_TILES, 8, BC.PIXELS_PER_TILE))
    pixel_in[:, 0:3] = 1.0
    pixel_in[:, 3:6] = fwd[:, 0:3]
    grad, mag = BC.blend_backward_torch(slab, starts, ends, pixel_in, **KW)
    assert not grad.any() and not mag.any()
    pixel_in[:, BC.PIXEL_IN_LAST] = fwd[:, BC.OUT_LAST_EFF]
    grad, _ = BC.blend_backward_torch(slab, starts, ends, pixel_in, **KW)
    for t in range(NUM_TILES):
        lo, hi = int(starts[t]), int(ends[t])
        assert float(grad[BC.GROW_NUM_PIXELS, lo:hi].sum()) == float(
            fwd[t, BC.OUT_COUNT].sum())


def test_backward_float64_reference():
    """blend_backward_torch in float64 keeps the float32 contributing set
    (the pixel counts are equal) and agrees with float32 at rtol 2e-3 /
    atol 1e-4 on the long-segment fixture."""
    slabs, starts, ends = long_segment_slab(C)
    slab = slabs["wide16"]
    fwd = BC.blend_forward_torch(slab, starts, ends, rgb_only=False, **KW)
    rng = np.random.default_rng(9)
    pixel_in = torch.zeros((NUM_TILES, 8, BC.PIXELS_PER_TILE))
    pixel_in[:, 0:3] = torch.as_tensor(rng.normal(
        size=(NUM_TILES, 3, BC.PIXELS_PER_TILE)).astype(np.float32))
    pixel_in[:, 3:6] = fwd[:, 0:3]
    pixel_in[:, BC.PIXEL_IN_LAST] = fwd[:, BC.OUT_LAST_EFF]
    f32 = BC.blend_backward_torch(slab, starts, ends, pixel_in, **KW)
    f64 = BC.blend_backward_torch(slab, starts, ends, pixel_in, **KW,
                                  dtype=torch.float64)
    assert f64[0].dtype == f64[1].dtype == torch.float64
    assert torch.equal(f64[0][BC.GROW_NUM_PIXELS],
                       f32[0][BC.GROW_NUM_PIXELS].double())
    float_rows = [r for r in BC.GRAD_ROWS if r != BC.GROW_NUM_PIXELS]
    np.testing.assert_allclose(f32[0][float_rows], f64[0][float_rows],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(f32[1], f64[1], rtol=RTOL, atol=ATOL)
    assert f64[0][float_rows].abs().max() > 0


@pytest.mark.parametrize("name", sorted(OPS_CONTRIBUTING))
def test_work_counts_pairs_by_cost(name):
    """work() charges each pair what it needs: the contributing pairs are
    the keys the plain versions blend, the skipped and saturating ones the
    rest of what the forward evaluates (K3: of the keys below `last`), and
    the bound is the larger of the bytes' and the operations' time."""
    slabs, starts, ends = long_segment_slab(C)
    slab = slabs["packed8" if name == "blend_forward_rgb" else "wide16"]
    fwd = BC.blend_forward_torch(slabs["wide16"], starts, ends,
                                 rgb_only=False, **KW)
    last = fwd[:, BC.OUT_LAST_EFF]
    w = work(name, slab, starts, ends, NUM_TILES, TILES_PER_ROW, last=last)
    counts = pair_counts(slab, starts, ends, last=last, **KW)
    blended = float(fwd[:, BC.OUT_COUNT].sum())
    if name == "blend_backward":
        assert w["contributing"] == int(counts["k3_contributing"].sum())
        skipped = w["pairs"] - w["contributing"]
        assert skipped == int(counts["k3_skipped"].sum())
        assert w["ops"] == (OPS_CONTRIBUTING[name] * w["contributing"]
                            + OPS_SKIPPED * skipped)
    else:
        evaluated = counts["contributing"] + counts["skipped"] \
            + counts["saturating"]
        assert w["pairs"] == int(evaluated.sum())
        assert w["ops"] == (OPS_CONTRIBUTING[name] * w["contributing"]
                            + OPS_SKIPPED * int(counts["skipped"].sum())
                            + OPS_SATURATING * int(counts["saturating"].sum()))
    # the same keys as the plain forward blends, up to pixels whose T
    # rounds across 1e-4 in the other product order
    assert abs(w["contributing"] - blended) <= 1e-3 * blended
    assert 0 < w["contributing"] <= w["pairs"] <= w["pairs_no_exit"]
    t_ops = w["ops"] / 67e12 * 1e3
    t_bytes = w["bytes"] / 3.35e12 * 1e3
    assert w["bound_ms"] == max(t_ops, t_bytes)
    assert w["bound_by"] == ("operations" if t_ops >= t_bytes else "bytes")


@pytest.mark.parametrize("chunk", [C, BC.CHUNK_KEYS])
def test_fixture_saturates_at_chunk_boundaries(chunk):
    """The long-segment fixture, at the test's chunk and at the kernels'
    (the one chip_smoke.py uses on the card), has pixels whose saturating
    key opens a later chunk, pixels that saturate inside a chunk, and the
    sequential count of evaluated pairs agrees with the plain forward."""
    slabs, starts, ends = long_segment_slab(chunk)
    counts = pair_counts(slabs["wide16"], starts, ends, **KW)
    sat_pos = counts["sat_pos"]
    evaluated = counts["contributing"] + counts["skipped"] \
        + counts["saturating"]
    seg = (ends - starts).long()[:, None].expand_as(evaluated)
    sat = sat_pos >= 0
    assert ((sat_pos % chunk == 0) & (sat_pos > 0)).any()
    assert (sat & (sat_pos % chunk != 0)).any()
    assert torch.equal(evaluated[sat], sat_pos[sat] + 1)
    assert torch.equal(evaluated[~sat], seg[~sat])
    assert sat[6].sum() == 0 and sat[7].all()
    if chunk == C:
        fwd = BC.blend_forward_torch(slabs["wide16"], starts, ends,
                                     rgb_only=False, **KW)
        last = fwd[:, BC.OUT_LAST_EFF] - starts[:, None]
        assert (sat_pos[sat] >= last[sat]).all()
