"""K6's plan on the CPU: `kernels.conv_s8.conv_plan` gives every shape the
paths run a route, keeps TMA's rules on the TMA and halo routes, sends the
shapes neither can take to the gather route, and each route's walk sums to
the plain int32 convolution: the TMA route's tensor maps' boxes, tap by
tap, with TMA's zero fill, the quantize pass's padding, the rectangles of
output pixels and the split-K partition; the halo route's persistent walk
over tiles, each tile's box with its halo, the int8 halo tile's layout and
the reduction's tap offsets. Both walks are emulated here byte for byte in
numpy, as the kernels (`csrc/conv_s8_tma.cuh`, `csrc/conv_s8_halo.cuh`)
walk them; a walk that drops a tap, a split, a channel block, a halo row or
column or the last tile is shown to miss. No card is needed.
"""

import os
import re

import numpy as np
import pytest
import torch

from dcnet_tpu_torch.kernels import conv_s8 as k6
from dcnet_tpu_torch.models.darknet import yolov3_layer_defs
from dcnet_tpu_torch.ops.quant import conv_shapes

# the trunk's shapes at P = 1024 (k, stride, pad, Ci, Co, side), as the
# kernel phase of chip_smoke.py runs them (K6_TRUNK)
TRUNK = ((1, 1, 0, 1024, 512, 32), (1, 1, 0, 512, 512, 32), (1, 1, 0, 1032, 512, 32),
         (3, 1, 1, 512, 512, 32), (1, 1, 0, 512, 256, 32), (1, 1, 0, 256, 512, 32))
FRAMES = (8, 40, 120, 320)     # a kernel case, a request, a tick, a big batch
X_DTYPES = ("int8", "bfloat16", "float32")


def _path_shapes():
    full = sorted({c[1:] for c in conv_shapes(yolov3_layer_defs(), 256)})
    return full + list(TRUNK)


def _all_plans():
    for (k, s, p, ci, co, side) in _path_shapes():
        for n in FRAMES:
            for dt in X_DTYPES:
                yield (n, side, side, ci, co, k, s, p, dt), k6.conv_plan(
                    n, side, side, ci, co, k, s, p, dt)


def test_every_path_shape_gets_a_route():
    """Every conv of the full backbone at 256 px and every trunk shape, at
    8-320 frames, in each input type, on wgmma s8 + TMA, float inputs and
    padded channels through the quantize pass; but the thin reductions (Ci
    < 64 or k^2 Ci < 256: the first layer, the 3x3 32 -> 64s, the 1x1s
    64 -> 32 and 128 -> 64), on the halo route."""
    seen, thin = 0, set()
    for (n, h, w, ci, co, k, s, p, dt), plan in _all_plans():
        if ci < 64 or k * k * ci < 256:
            assert plan.route == "halo" and "thin" in plan.why, (ci, dt, plan.why)
            thin.add((k, s, ci, co))
            continue
        assert plan.route == "tma", (n, h, ci, co, k, s, dt, plan.why)
        assert plan.quant_x == (dt != "int8" or ci % 16 != 0)
        assert plan.pad_w == (ci % 16 != 0) and plan.cp % 16 == 0 and plan.cp >= ci
        seen += 1
    assert thin == {(3, 1, 3, 32), (3, 1, 32, 64), (3, 2, 32, 64), (1, 1, 64, 32),
                    (1, 1, 128, 64)}
    assert seen == (len(_path_shapes()) - len(thin)) * len(FRAMES) * len(X_DTYPES)


def test_tma_rules_hold_on_the_tma_route():
    """Global strides multiples of 16 bytes below 2^40, dims 1..2^32, box
    dims at most 256, the inner box a multiple of 16 bytes and one swizzle
    span, 128 rows a box, each phase view inside x and its dims not
    overlapping, shared memory within 232,448 B, the split within a
    cluster and each split at least one iteration, the grid within CUDA's."""
    for (n, h, w, ci, co, k, s, p, dt), plan in _all_plans():
        if plan.route != "tma":
            continue
        x_bytes = n * h * w * plan.cp
        assert plan.cbox in (64, 128)
        assert plan.cbox % 16 == 0 and plan.bn in (64, 128, 256)
        assert plan.bw * plan.bh * plan.bimg == k6.TMA_ROWS
        for box in ((plan.cbox, plan.bw, plan.bh, plan.bimg), (plan.cbox, 1, plan.bn)):
            assert all(1 <= b <= 256 for b in box)
        for off, dims, strides in plan.a_maps:
            assert off % 16 == 0 and all(st % 16 == 0 and 0 < st < 2 ** 40 for st in strides)
            assert all(1 <= d < 2 ** 32 for d in dims)
            assert dims[0] == plan.cp
            steps = (1, *strides)
            for i in range(3):   # dims do not overlap the next one's stride
                assert dims[i] * steps[i] <= steps[i + 1], (dims, strides)
            last = off + sum((d - 1) * st for d, st in zip(dims, steps))
            assert last < x_bytes
        assert all(st % 16 == 0 for st in plan.b_strides)
        assert plan.b_dims == (plan.cp, k * k, co)
        assert plan.smem <= k6.SMEM_LIMIT and 2 <= plan.stages <= k6.MAX_STAGES
        assert 1 <= plan.splits <= k6.MAX_SPLITS and plan.kiters >= plan.splits
        assert all(plan.split_range(i)[1] > plan.split_range(i)[0]
                   for i in range(plan.splits))
        gx, gy, gz = plan.grid
        assert gx < 2 ** 31 and gy <= 65535 and gz == plan.splits
        assert len(plan.array()) == len(k6.TMA_FIELDS) + 8 * len(plan.a_maps) + 3 * len(plan.taps)


def test_plan_fields_match_the_kernel():
    """TMA_FIELDS lists the C entry's plan fields in the order of
    `tma::Field`."""
    src = open(os.path.join(os.path.dirname(k6.__file__), "..", "csrc",
                            "conv_s8_tma.cuh")).read()
    body = re.search(r"enum Field \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == "kfFields"
    assert [n.lower() for n in names[:-1]] == ["kf" + f.replace("_", "")
                                                for f in k6.TMA_FIELDS]


@pytest.mark.parametrize("case,why", [
    (dict(ci=3, x_dtype="bfloat16"), "thin"),
    (dict(ci=32, x_aligned=False), "thin"),
    (dict(ci=12, k=1, pad=0, stride=1), "thin"),
    (dict(x_dtype="int8", x_aligned=False), "aligned"),
    (dict(x_dtype="int8", w_aligned=False), "aligned"),
    (dict(x_dtype="bfloat16", w_aligned=False), "aligned"),
    (dict(h=11), "odd side"),
    (dict(k=9, pad=4), "taps"),
    (dict(stride=5, k=5, pad=2), "phase maps"),
])
def test_shapes_tma_cannot_take_gather(case, why):
    """A thin reduction (Ci < 64 or k^2 Ci < 256) the halo route cannot map
    (rows of x not a multiple of 16 bytes, x off 16-byte alignment), an int8
    operand off 16-byte alignment that needs no padded copy, a phase view
    past the image (odd side at stride 2), more than 64 taps or 16 phase
    maps: the gather route."""
    args = dict(n=2, h=12, w=13, ci=64, co=64, k=3, stride=2, pad=1, x_dtype="int8",
                x_aligned=True, w_aligned=True)
    args.update(case)
    plan = k6.conv_plan(**args)
    assert plan.route == "gather" and why in plan.why, plan.why


def test_misaligned_operands_that_are_copied_keep_the_tma_route():
    """A float x, or an int8 operand whose channels are padded, is copied by
    the quantize pass into an aligned buffer: alignment does not matter."""
    for args in (dict(ci=64, x_dtype="bfloat16", x_aligned=False),
                 dict(ci=1032, x_dtype="int8", x_aligned=False, w_aligned=False),
                 dict(ci=72, x_dtype="float32", x_aligned=False, w_aligned=False)):
        plan = k6.conv_plan(2, 12, 12, co=64, k=3, stride=1, pad=1, **args)
        assert plan.route == "tma" and plan.quant_x, args


# --- the walk, emulated ----------------------------------------------------

def _tma_box(buf, off, dims, strides, coords, box):
    """What a tiled TMA load of `box` at `coords` writes, as rows of box[0]
    bytes: elements outside dims zero-filled, others read at the map's byte
    offset and strides (dim 0 contiguous, one byte an element)."""
    grids = np.meshgrid(*[c + np.arange(b) for c, b in zip(coords, box)], indexing="ij")
    valid = np.ones(grids[0].shape, bool)
    addr = np.full(grids[0].shape, off, np.int64)
    for g, d, st in zip(grids, dims, (1, *strides)):
        valid &= (g >= 0) & (g < d)
        addr += g * st
    vals = np.where(valid, buf[np.where(valid, addr, 0)], 0)
    # rows: the outer dims, innermost (dim 1) fastest
    return vals.transpose(*range(len(box) - 1, -1, -1)).reshape(-1, box[0])


def walk(plan, xq, wq, drop=None):
    """The int32 sums the kernel computes by the plan: each block's split
    ranges of (tap, channel box) iterations, one box of x and one of w an
    iteration, the splits summed, the tile's rows scattered to their output
    pixels. `drop` leaves out tap 1, split 1 or channel box 1."""
    n = xq.shape[0]
    xbuf = xq.reshape(-1).astype(np.int64)
    wbuf = wq.reshape(-1).astype(np.int64)
    co = plan.co
    out = np.zeros((n * plan.ho * plan.wo, co), np.int64)
    gx, gy, _ = plan.grid
    r = np.arange(k6.TMA_ROWS)
    for mt in range(gx):
        tw, th, tn = (mt % plan.tiles_w, (mt // plan.tiles_w) % plan.tiles_h,
                      mt // (plan.tiles_w * plan.tiles_h))
        ow = tw * plan.bw + r % plan.bw
        oh = th * plan.bh + (r // plan.bw) % plan.bh
        on = tn * plan.bimg + r // (plan.bw * plan.bh)
        ok = (ow < plan.wv) & (oh < plan.hv) & (on < plan.nv)
        rows = ((on * plan.hv + oh) * plan.wv + ow)[ok]
        for nt in range(gy):
            tile = np.zeros((k6.TMA_ROWS, plan.bn), np.int64)
            for sp in range(plan.splits):
                if drop == "split" and sp == 1:
                    continue
                begin, end = plan.split_range(sp)
                for it in range(begin, end):
                    tap, cb = divmod(it, plan.cblocks)
                    if (drop == "tap" and tap == 1) or (drop == "cblock" and cb == 1):
                        continue
                    m, dw, dh = plan.taps[tap]
                    off, dims, strides = plan.a_maps[m]
                    a = _tma_box(xbuf, off, dims, strides,
                                 (cb * plan.cbox, tw * plan.bw + dw, th * plan.bh + dh,
                                  tn * plan.bimg), (plan.cbox, plan.bw, plan.bh, plan.bimg))
                    b = _tma_box(wbuf, 0, plan.b_dims, plan.b_strides,
                                 (cb * plan.cbox, tap, nt * plan.bn), (plan.cbox, 1, plan.bn))
                    tile += a @ b.T
            c0 = nt * plan.bn
            cols = min(plan.bn, co - c0)
            out[rows, c0:c0 + cols] = tile[ok, :cols]
    return out.reshape(n, plan.ho, plan.wo, co)


# (n, h, w, Ci, Co, k, stride, pad): k 1 / 3, stride 1 / 2, pad 0 / 1, Ci
# 64 / 72 / 80 / 160 / 256 / 288 / 1032 (64- and 128-byte boxes, two or
# more channel boxes, padding to 16; thinner reductions gather), odd sides
# (odd heights only at stride 1: at stride 2 they gather), N 1-3
WALKS = ((1, 7, 5, 72, 8, 3, 1, 1), (2, 6, 9, 64, 24, 3, 2, 1), (3, 5, 5, 256, 70, 1, 1, 0),
         (2, 9, 11, 64, 40, 3, 1, 0), (1, 8, 7, 160, 130, 3, 2, 1), (2, 4, 6, 256, 16, 1, 2, 0),
         (3, 3, 3, 64, 300, 3, 1, 1), (1, 10, 10, 288, 33, 1, 1, 0), (2, 12, 12, 80, 9, 3, 2, 0),
         (2, 3, 3, 1032, 20, 1, 1, 0))


def _walk_inputs(case, x_dtype="int8"):
    n, h, w, ci, co, k, s, p = case
    rng = np.random.default_rng(ci * 131 + co * 7 + k)
    w_ = rng.integers(-127, 128, (co, k, k, ci), dtype=np.int8)
    if x_dtype == "int8":
        x = torch.from_numpy(rng.integers(-127, 128, (n, h, w, ci), dtype=np.int8))
        xq = x
    else:
        x = torch.from_numpy(rng.standard_normal((n, h, w, ci)).astype(np.float32))
        xq = k6.quantize_plain(x, in_inv=40.0)
    plan = k6.conv_plan(n, h, w, ci, co, k, s, p, x_dtype)
    pad_c = ((0, 0),) * 3 + ((0, plan.cp - ci),)
    xp = np.pad(xq.numpy(), pad_c)          # the quantize pass's copy
    wp = np.pad(w_, pad_c)
    want = k6.conv_s8_acc_plain(xq, torch.from_numpy(w_), s, p).numpy()
    return plan, xp, wp, want


@pytest.mark.parametrize("case", WALKS, ids=lambda c: "n{}-{}x{}-ci{}-co{}-k{}s{}p{}".format(*c))
@pytest.mark.parametrize("x_dtype", ["int8", "float32"])
def test_walk_equals_the_plain_convolution(case, x_dtype):
    plan, xp, wp, want = _walk_inputs(case, x_dtype)
    assert plan.route == "tma", plan.why
    got = walk(plan, xp, wp)
    np.testing.assert_array_equal(got, want)


def test_walks_cover_splits_channel_boxes_and_phases():
    """The cases above reach split-K, two channel boxes, the padded pass
    and the four phase maps of a stride-2 3x3."""
    plans = [k6.conv_plan(*c) for c in WALKS]
    assert any(p.splits >= 2 for p in plans)
    assert any(p.cblocks >= 2 for p in plans)
    assert any(p.pad_w for p in plans)
    assert any(len(p.a_maps) == 4 for p in plans)
    assert {p.cbox for p in plans} == {64, 128}


@pytest.mark.parametrize("drop,case", [("tap", WALKS[1]), ("split", WALKS[4]),
                                       ("cblock", WALKS[4]), ("cblock", WALKS[7])])
def test_walk_that_drops_work_misses(drop, case):
    """The check is not blind: leaving out a tap, a split or a channel box
    changes the sums."""
    plan, xp, wp, want = _walk_inputs(case)
    if drop == "split":
        assert plan.splits >= 2
    if drop == "cblock":
        assert plan.cblocks >= 2
    got = walk(plan, xp, wp, drop=drop)
    assert not np.array_equal(got, want)


def test_quant_pass_plain_pads_and_quantizes():
    """The quantize pass's plain version: `quantize_plain`, then zero
    channels up to cp."""
    x = torch.randn(2, 3, 5, 24, generator=torch.Generator().manual_seed(1))
    got = k6.quant_pass(x, 32, in_inv=30.0)
    assert got.dtype == torch.int8 and got.shape == (2, 3, 5, 32)
    assert torch.equal(got[..., :24], k6.quantize_plain(x, in_inv=30.0))
    assert not got[..., 24:].any()
    s = torch.tensor(0.05)
    assert torch.equal(k6.quant_pass(x, 32, in_scale=s)[..., :24], k6.quantize_plain(x, in_scale=s))
    xi = torch.randint(-127, 128, (4, 1032), dtype=torch.int8)
    assert torch.equal(k6.quant_pass(xi, 1040)[:, :1032], xi)


def test_padded_weights_are_kept_until_written():
    """A w whose channels the TMA route pads is padded once and the copy
    kept on w; a write to w makes the pass due again. An inference
    tensor keeps no copy."""
    w = torch.randint(-127, 128, (8, 1, 1, 1032), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(2))
    assert k6.pad_w_due(w, 1040)
    first = k6._padded_w(w, 1040)
    assert not k6.pad_w_due(w, 1040) and k6._padded_w(w, 1040) is first
    assert torch.equal(first, k6.quant_pass_plain(w, 1040))
    assert k6.pad_w_due(w, 1056)
    w[0, 0, 0, 0] = 5
    assert k6.pad_w_due(w, 1040)
    assert torch.equal(k6._padded_w(w, 1040), k6.quant_pass_plain(w, 1040))
    with torch.inference_mode():  # no version counter: padded at every call
        wi = w.clone()
    assert k6.pad_w_due(wi, 1040)
    assert torch.equal(k6._padded_w(wi, 1040), k6.quant_pass_plain(w, 1040))
    assert k6.pad_w_due(wi, 1040) and not hasattr(wi, "_k6_padded")


# --- the halo route --------------------------------------------------------

def _thin_path_plans():
    for (n, h, w, ci, co, k, s, p, dt), plan in _all_plans():
        if ci < 64 or k * k * ci < 256:
            yield (n, h, w, ci, co, k, s, p, dt), plan


def test_halo_plan_obeys_tma_rules_and_the_card():
    """At every thin path shape, frame count and input type: x's map with
    global strides multiples of 16 bytes below 2^40, dims 1..2^32, box dims
    at most 256 with an inner box of whole 16-byte units, the box a whole
    halo (of pixels, on a row map), the int8 halo tile covering every tap
    of every row, shared memory within 232,448 B and two blocks an SM (the
    flat row map among them, for the first layer), the fields in the
    order of the kernel's."""
    kinds = set()
    for (n, h, w, ci, co, k, s, p, dt), plan in _thin_path_plans():
        hp = plan.halo
        es = k6._ITEMSIZE[dt]
        kinds.add(hp.kind)
        assert all(st % 16 == 0 and 0 < st < 2 ** 40 for st in (hp.s1, hp.s2, hp.s3))
        assert all(1 <= d < 2 ** 32 for d in (hp.d0, hp.d1, hp.d2, hp.d3))
        assert all(1 <= b <= 256 for b in (hp.b0, hp.b1, hp.b2))
        assert (hp.b0 * es) % 16 == 0 and hp.box_bytes == hp.b0 * hp.b1 * hp.b2 * es
        assert hp.th * hp.tw == k6.HALO_ROWS
        assert hp.hin == (hp.th - 1) * s + k and hp.win == (hp.tw - 1) * s + k
        if hp.kind == 0:
            assert (hp.b0, hp.b1, hp.b2) == (ci, hp.win, hp.hin) and hp.row_elems == hp.win * ci
        else:
            assert hp.b0 >= hp.lead + hp.win * ci and hp.b1 == hp.hin
            assert hp.row_elems == hp.b0 and hp.d0 == w * ci
            assert all((hp.box_coords(t)[0] * es) % 16 == 0 for t in range(hp.tiles_w))
        assert hp.cp >= ci and hp.cp & (hp.cp - 1) == 0 and hp.kp % 32 == 0
        last = ((hp.th - 1) * s * hp.rpitch + (hp.tw - 1) * s) * hp.ppitch + max(hp.tap_offsets())
        assert last + 4 <= hp.hin * hp.rpitch * hp.ppitch <= hp.off_w - hp.off_halo
        out_end = hp.off_out + k6.HALO_ROWS * (hp.out_es * hp.nchunk + 16)
        assert out_end <= hp.off_w and (hp.off_out == hp.off_halo) == (hp.cochunks == 1)
        assert hp.ppitch % 16 == 0 or hp.cp < 16
        per_sm = min(k6.SM_SMEM // (hp.smem + 1024), k6.halo_per_sm(hp.nchunk))
        assert hp.smem <= k6.SMEM_LIMIT and per_sm >= (1 if dt == "float32" else 2)
        assert hp.off_halo >= hp.stages * hp.raw_bytes >= hp.stages * hp.box_bytes
        assert hp.off_bar + 8 * hp.stages + 1024 == hp.smem
        assert hp.grid == min(hp.tiles, k6.SMS * per_sm)
        assert hp.hin * hp.win * hp.cp // 4 < 2 ** 16   # the kernel's exact divisions
        assert hp.tiles == hp.tiles_w * hp.tiles_h * hp.nv
        assert hp.tiles_w * hp.tw >= hp.wv and hp.tiles_h * hp.th >= hp.hv
        assert len(plan.array()) == len(k6.HALO_FIELDS)
    assert kinds == {0, 1}
    src = open(os.path.join(os.path.dirname(k6.__file__), "..", "csrc",
                            "conv_s8_halo.cuh")).read()
    body = re.search(r"enum Field \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == "kfFields"
    assert [n.lower() for n in names[:-1]] == ["kf" + f.replace("_", "")
                                                for f in k6.HALO_FIELDS]


def halo_walk(plan, xq, w, drop=None):
    """The int32 sums the halo kernel computes by the plan: each persistent
    block's tiles (t = block, block + grid, ...), each tile's TMA box (zero
    fill outside x), the box written into the int8 halo tile as the kernel
    lays it out (Cp channels a pixel, ppitch bytes apart, channels past Ci
    zero, rpitch pixels a row), A read from it word by word at each row's pixel plus
    the tap offset of the word, B from w laid out in (tap, channel) order,
    and the tile's rows scattered to their output pixels. `drop` leaves out
    the halo's last row or column, tap 1 or the last tile."""
    hp = plan.halo
    n, co = xq.shape[0], w.shape[0]
    xbuf = xq.reshape(-1).astype(np.int64)
    es = hp.s1 // hp.d0                      # x's element size: dim 1 is a row of dim 0
    es_strides = [st // es for st in (hp.s1, hp.s2, hp.s3)]
    dims, box = (hp.d0, hp.d1, hp.d2, hp.d3), (hp.b0, hp.b1, hp.b2, 1)
    taps = hp.k * hp.k
    # w as the kernel stages it: rows of kp bytes, (tap, channel), zero padded
    wk = np.zeros((hp.cochunks * hp.nchunk, taps, hp.cp), np.int64)
    wk[:co, :, :hp.ci] = w.reshape(co, taps, hp.ci)
    wk = np.pad(wk.reshape(wk.shape[0], -1), ((0, 0), (0, hp.kp - taps * hp.cp)))
    offs = np.array(hp.tap_offsets())
    if drop == "tap":
        offs = np.where((np.arange(hp.kp // 4) * 4) // hp.cp == 1, -1, offs)
    r = np.arange(k6.HALO_ROWS)
    pix = ((r // hp.tw) * hp.rpitch + r % hp.tw) * hp.stride
    word = (pix[:, None] * hp.ppitch + np.maximum(offs, 0)[None, :])  # (rows, kp / 4)
    addr = word[:, :, None] + np.arange(4)                              # bytes of each word
    size = hp.hin * hp.rpitch * hp.ppitch
    assert addr.max() < size
    hr, hc, ch = np.meshgrid(np.arange(hp.hin), np.arange(hp.win), np.arange(hp.cp),
                             indexing="ij")
    dst = ((hr * hp.rpitch + hc) * hp.ppitch + ch).reshape(-1)
    assert len(np.unique(dst)) == dst.size          # no two bytes of the tile overlap
    src = (hr * hp.row_elems + hp.lead + hc * hp.ci + np.minimum(ch, hp.ci - 1)).reshape(-1)
    real = (ch < hp.ci).reshape(-1)
    out = np.zeros((n * plan.ho * plan.wo, co), np.int64)
    tiles = [t for b in range(hp.grid) for t in range(b, hp.tiles, hp.grid)]
    assert sorted(tiles) == list(range(hp.tiles))
    for t in tiles:
        if drop == "tile" and t == hp.tiles - 1:
            continue
        raw = _tma_box(xbuf, 0, dims, es_strides, hp.box_coords(t), box).reshape(-1)
        if drop == "row":
            raw = raw.reshape(hp.hin, -1).copy()
            raw[-1] = 0
        elif drop == "col":
            raw = raw.reshape(hp.hin, -1).copy()
            raw[:, hp.lead + (hp.win - 1) * hp.ci:hp.lead + hp.win * hp.ci] = 0
        tile8 = np.zeros(size, np.int64)
        tile8[dst] = np.where(real, raw.reshape(-1)[src], 0)
        a = tile8[addr].reshape(k6.HALO_ROWS, -1)                       # (rows, kp)
        if drop == "tap":
            a = a * np.repeat(offs >= 0, 4)[None, :]
        acc = a @ wk.T
        img, oh0, ow0 = hp.tile_origin(t)
        oh, ow = oh0 + r // hp.tw, ow0 + r % hp.tw
        ok = (oh < hp.hv) & (ow < hp.wv)
        rows = (img * hp.hv + oh) * hp.wv + ow
        out[rows[ok]] = acc[ok, :co]
    return out.reshape(n, plan.ho, plan.wo, co)


# (n, h, w, Ci, Co, k, stride, pad, x dtype): the first layer's flat row map
# (fp32 and int8), stride 2 (four input pixels an output), odd sides and
# tiles cut by the image edge, the 1x1s' 128-pixel runs with a tail tile
# and a persistent walk of more tiles than blocks (N 4), Ci 4 / 16 / 24 (Cp 4 / 16
# / 32: a step spanning 8, 2 or 1 taps), Co 40 / 80 (passes of 64
# columns), N 1-3
HALO_WALKS = ((1, 32, 32, 3, 32, 3, 1, 1, "float32"), (2, 17, 16, 3, 32, 3, 1, 1, "int8"),
              (3, 16, 16, 32, 64, 3, 2, 1, "bfloat16"), (2, 15, 9, 32, 64, 3, 1, 1, "int8"),
              (1, 12, 20, 64, 32, 1, 1, 0, "bfloat16"), (2, 9, 7, 128, 64, 1, 1, 0, "float32"),
              (4, 128, 128, 64, 32, 1, 1, 0, "int8"), (3, 8, 8, 24, 40, 3, 1, 1, "int8"),
              (2, 10, 10, 16, 80, 3, 1, 1, "int8"), (1, 8, 12, 4, 32, 3, 2, 1, "int8"),
              (2, 11, 13, 32, 64, 3, 2, 1, "float32"))


def _halo_inputs(case):
    n, h, w, ci, co, k, s, p, dt = case
    rng = np.random.default_rng(ci * 131 + co * 7 + k + h)
    w_ = rng.integers(-127, 128, (co, k, k, ci), dtype=np.int8)
    if dt == "int8":
        xq = torch.from_numpy(rng.integers(-127, 128, (n, h, w, ci), dtype=np.int8))
    else:
        x = torch.from_numpy(rng.standard_normal((n, h, w, ci)).astype(np.float32))
        xq = k6.quantize_plain(x.to(getattr(torch, dt)), in_inv=40.0)
    plan = k6.conv_plan(n, h, w, ci, co, k, s, p, dt)
    want = k6.conv_s8_acc_plain(xq, torch.from_numpy(w_), s, p).numpy()
    return plan, xq.numpy(), w_, want


@pytest.mark.parametrize("case", HALO_WALKS,
                         ids=lambda c: "n{}-{}x{}-ci{}-co{}-k{}s{}p{}-{}".format(*c))
def test_halo_walk_equals_the_plain_convolution(case):
    plan, xq, w_, want = _halo_inputs(case)
    assert plan.route == "halo", plan.why
    np.testing.assert_array_equal(halo_walk(plan, xq, w_), want)


def test_halo_walks_cover_the_plan():
    """The cases above reach both maps, Cp 4 / 16 / 32 / 64 / 128, stride 2,
    rings of one to four slots, a tail tile, more than one pass over
    Co and a persistent walk of more tiles than blocks."""
    hps = [k6.conv_plan(*c).halo for c in HALO_WALKS]
    assert {hp.kind for hp in hps} == {0, 1}
    assert {4, 16, 32, 64, 128} <= {hp.cp for hp in hps}
    assert any(hp.stride == 2 for hp in hps) and any(hp.cochunks > 1 for hp in hps)
    assert 1 in {hp.stages for hp in hps} and max(hp.stages for hp in hps) > 1
    assert any(hp.tiles > hp.grid for hp in hps)
    assert any(hp.tiles_w * hp.tw > hp.wv or hp.tiles_h * hp.th > hp.hv for hp in hps)


@pytest.mark.parametrize("drop,case", [("row", HALO_WALKS[0]), ("col", HALO_WALKS[0]),
                                       ("tap", HALO_WALKS[2]), ("tile", HALO_WALKS[5]),
                                       ("tile", HALO_WALKS[6])])
def test_halo_walk_that_drops_work_misses(drop, case):
    """The check is not blind: a walk that drops the halo's last row or
    column, a tap or the last tile does not match."""
    plan, xq, w_, want = _halo_inputs(case)
    assert not np.array_equal(halo_walk(plan, xq, w_, drop=drop), want)
