"""``ops/mbconv.py::mbconv_plan``: which launches kernel 2 takes for a block,
decided from its shape alone (pure Python, so it runs on the CPU).

The cluster path (``csrc/mbconv.cu``) keeps one image's expanded map in the
shared memory of a thread-block cluster; a shape whose map no cluster of
16 CTAs can hold whole takes the band form, the same cluster holding the
map one row band at a time; a shape whose channels are not multiples of 8
takes the three launches of ``csrc/mbconv_tiled.cu``."""

import pytest
import torch

from p4fr_tpu_torch.ops.mbconv import (
    BAND_TILES,
    MAX_BAND_WIDTH,
    MAX_TILES,
    MAX_WIDTH,
    RING_MAX,
    SMEM_LIMIT,
    band_chunks,
    band_n_tiles,
    band_rows,
    band_scratch_shape,
    launch_a_layout,
    launch_a_tiles,
    mbconv_plan,
)

# EfficientSATRN's stride-1 blocks (256x512 input): (H, W, Cin, Cmid, Cout,
# SE hidden) and the cluster size the plan gives them
FLAGSHIP = {
    "stage3_tail": ((16, 32, 128, 512, 128, 32), 8),
    "stage4_head": ((16, 32, 128, 768, 160, 32), 16),
    "stage4_tail": ((16, 32, 160, 960, 160, 40), 16),
    "stage5_tail": ((8, 16, 256, 1536, 256, 64), 16),
}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def check_cluster_plan(plan, h, w, cin, cmid, se_dim, dtype):
    """A cluster plan's invariants: slices of whole 8-channel groups that
    cover every mid channel once, in order; the widest is the plan's
    width; the image's expand tiles fit the warps' registers, the
    depthwise sweep fits, and the shared memory fits the card."""
    assert plan.path == "cluster"
    assert plan.cluster in (1, 2, 4, 8, 16)
    check_slices(plan, cmid)
    wm = plan.warp_rows
    mpw, npw = launch_a_tiles(h * w, plan.width, wm)
    assert 16 % wm == 0 and mpw in (2, 4) and 2 <= npw <= MAX_TILES
    assert wm * mpw * 16 >= h * w and (16 // wm) * npw * 8 >= plan.width
    assert w <= MAX_WIDTH
    assert 2 <= plan.stages <= RING_MAX
    assert (plan.smem, plan.stages) == launch_a_layout(h, w, cin, plan.width, plan.cluster,
                                                       se_dim, wm, dtype == torch.bfloat16)
    assert plan.smem <= SMEM_LIMIT
    assert (plan.bands, plan.m_tiles) == (1, 0)


def check_slices(plan, cmid):
    """Slices of whole 8-channel groups that cover every mid channel once,
    in order, the widest the plan's width, within one group of each other."""
    start = 0
    for s, width in plan.slices:
        assert s == start and width > 0 and s % 8 == 0 and width % 8 == 0
        start += width
    assert start == cmid and len(plan.slices) == plan.cluster
    assert plan.width == max(width for _, width in plan.slices)
    assert max(wd for _, wd in plan.slices) - min(wd for _, wd in plan.slices) <= 8


def check_band_plan(plan, h, w, cin, cmid, se_dim, dtype):
    """A band plan's invariants: the bands cover every row once, in order;
    each band expands its rows and one halo row at each inner edge; its
    pixel chunks' tiles fit the warps' registers (an instance's tiling) and
    cover its expand rows; the shared memory is the kernel's layout and
    fits the card with a ring of at least 2 slots; the scratch holds every
    band but the last, per persistent cluster."""
    assert plan.path == "band" and plan.cluster in (1, 2, 4, 8, 16)
    check_slices(plan, cmid)
    assert 2 <= plan.bands <= h and w <= MAX_BAND_WIDTH
    covered = []
    for k in range(plan.bands):
        r0, r1, e0, e1 = band_rows(h, plan.bands, k)
        assert r1 > r0
        covered += range(r0, r1)
        assert e0 == (r0 - 1 if k > 0 else 0) and e1 == (r1 + 1 if k + 1 < plan.bands else h)
    assert covered == list(range(h))
    wm, mpw = plan.warp_rows, plan.m_tiles
    npw = band_n_tiles(plan.width, wm)
    assert 16 % wm == 0 and (mpw, npw) in BAND_TILES
    assert mpw <= MAX_TILES and npw <= MAX_TILES and (16 // wm) * npw * 8 >= plan.width
    chunks = band_chunks(h, w, plan.bands, wm, mpw)
    for k in range(plan.bands):
        _, _, e0, e1 = band_rows(h, plan.bands, k)
        mine = [(start, px, mt) for band, start, px, mt in chunks if band == k]
        assert [start for start, _, _ in mine] == list(range(0, (e1 - e0) * w, wm * mpw * 16))
        assert sum(px for _, px, _ in mine) == (e1 - e0) * w
        assert all(mt == -(-px // 16) <= wm * mpw for _, px, mt in mine)
    assert 2 <= plan.stages <= RING_MAX
    assert (plan.smem, plan.stages) == launch_a_layout(
        h, w, cin, plan.width, plan.cluster, se_dim, wm, dtype == torch.bfloat16, plan.bands,
        mpw)
    assert plan.smem <= SMEM_LIMIT
    tallest = max(r1 - r0 for r0, r1, _, _ in (band_rows(h, plan.bands, k)
                                                for k in range(plan.bands)))
    shape = band_scratch_shape(7, h, w, cmid, plan.bands)
    assert shape == (7, plan.bands - 1, tallest * w, cmid)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("batch", [256, 32])
@pytest.mark.parametrize("name", FLAGSHIP)
def test_flagship_shapes_take_the_cluster_path(name, batch, dtype):
    (h, w, cin, cmid, cout, rd), cluster = FLAGSHIP[name]
    plan = mbconv_plan(batch, h, w, cin, cmid, cout, dtype, se_dim=rd)
    check_cluster_plan(plan, h, w, cin, cmid, rd, dtype)
    assert plan.cluster == cluster


# today's flagship plans, field for field: (C, slice width, warp rows, ring
# slots, shared memory) per type; every one holds the whole image (bands 1)
FLAGSHIP_PLANS = {
    "stage3_tail": {"bf16": (8, 64, 8, 4, 211968), "f32": (8, 64, 8, 6, 201728)},
    "stage4_head": {"bf16": (16, 48, 8, 3, 173120), "f32": (16, 48, 8, 5, 160832)},
    "stage4_tail": {"bf16": (16, 64, 8, 4, 220224), "f32": (16, 64, 8, 6, 211520)},
    "stage5_tail": {"bf16": (16, 96, 4, 6, 149632), "f32": (16, 96, 4, 6, 166016)},
}


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPES.keys())
@pytest.mark.parametrize("name", FLAGSHIP)
def test_flagship_plans_are_pinned(name, dtype):
    """The band form leaves every flagship plan as it was."""
    (h, w, cin, cmid, cout, rd), _ = FLAGSHIP[name]
    c, width, wm, stages, smem = FLAGSHIP_PLANS[name][dtype]
    groups = cmid // 8
    slices = tuple((8 * (groups * r // c), 8 * (groups * (r + 1) // c - groups * r // c))
                   for r in range(c))
    assert mbconv_plan(256, h, w, cin, cmid, cout, DTYPES[dtype], se_dim=rd) == (
        "cluster", c, slices, width, wm, stages, smem, 1, 0)


# (H, W, Cin, Cmid, Cout, SE hidden) -> the path and cluster size the design
# gives it, in both types
ROUTES = [
    # EfficientASTER's 256x1024 input: the stage-4 map is 16x64x960x4 B =
    # 3.9 MB an image, and stage 3's 2 MB, and 64 columns: the band form,
    # two bands of 8 rows (the same cluster sizes as the flagship's)
    ((16, 64, 160, 960, 160, 40), "band", 16),
    ((16, 64, 128, 512, 128, 32), "band", 8),
    ((8, 32, 256, 1536, 256, 64), "cluster", 16),
    # the small ragged shapes of tests/test_torch_kernels.py (11x19)
    ((11, 19, 24, 96, 40, 6), "cluster", 1),
    ((11, 19, 32, 128, 32, 0), "cluster", 1),
    ((11, 19, 40, 160, 40, 10), "cluster", 2),
    ((11, 19, 80, 320, 80, 20), "cluster", 4),
    # channels that are not multiples of 8: the cluster kernels move 16-byte
    # vectors of whole 8-channel groups
    ((11, 19, 12, 48, 12, 3), "tiled", 0),
    # EfficientASTER's stage-4 head, 128 -> 768 -> 160
    ((16, 64, 128, 768, 160, 32), "band", 16),
    # narrow channels at ASTER's width: an image's map fits a smaller cluster
    ((16, 64, 16, 96, 16, 4), "band", 2),
    # 13 rows: two bands of 6 and 7 rows
    ((13, 64, 160, 960, 160, 40), "band", 16),
    # wider than the band form's depthwise: the tiled path
    ((16, 80, 16, 96, 16, 4), "tiled", 0),
]


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("shape,path,cluster", ROUTES,
                         ids=["aster_s4", "aster_s3", "aster_s5", "ragged_c1", "ragged_c1_no_se",
                              "ragged_c2", "ragged_c4", "not_multiple_of_8", "aster_s4_head",
                              "narrow_16x64", "band_13_rows", "wider_than_64"])
def test_plan_routes_each_shape(shape, path, cluster, dtype):
    h, w, cin, cmid, cout, rd = shape
    plan = mbconv_plan(3, h, w, cin, cmid, cout, dtype, se_dim=rd)
    assert (plan.path, plan.cluster) == (path, cluster)
    if path == "cluster":
        check_cluster_plan(plan, h, w, cin, cmid, rd, dtype)
    elif path == "band":
        check_band_plan(plan, h, w, cin, cmid, rd, dtype)
    else:
        assert plan.slices == () and plan.smem == 0 and plan.bands == 0


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("shape", [(16, 64, 160, 960, 160, 40), (16, 64, 128, 512, 128, 32),
                                   (16, 64, 128, 768, 160, 32)],
                         ids=["aster_s4_tail", "aster_s3", "aster_s4_head"])
def test_aster_shapes_take_two_bands_of_eight_rows(shape, dtype):
    """ASTER's 16x64 maps: rows 0-7, then 8-15, each expanding 9 rows of 64
    (1.125x the useful expand)."""
    h, w, cin, cmid, cout, rd = shape
    plan = mbconv_plan(256, h, w, cin, cmid, cout, dtype, se_dim=rd)
    assert plan.bands == 2
    assert [band_rows(h, 2, k) for k in range(2)] == [(0, 8, 0, 9), (8, 16, 7, 16)]
    assert sum(px for _, _, px, _ in band_chunks(h, w, 2, plan.warp_rows, plan.m_tiles)) == (
        2 * 9 * 64)


@pytest.mark.parametrize("name", [*FLAGSHIP, "aster_s4_tail"])
def test_plan_depends_on_the_shape_alone(name):
    """The batch never changes the plan (persistent clusters walk it)."""
    (h, w, cin, cmid, cout, rd), _ = FLAGSHIP.get(name, ((16, 64, 160, 960, 160, 40), 16))
    plans = {mbconv_plan(b, h, w, cin, cmid, cout, torch.bfloat16, se_dim=rd)
             for b in (1, 7, 32, 256, 1000)}
    assert len(plans) == 1


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("shape", [(12, 32, 32, 128, 32, 8), (16, 24, 32, 128, 32, 8),
                                   (6, 32, 64, 256, 64, 16)],
                         ids=["12x32", "16x24", "6x32"])
def test_whole_image_plans_take_an_instance(shape, dtype):
    """Maps of 24 m-tiles: the tiling that pads none (8 warps of 3 m-tiles)
    has no launch-A instance (2 or 4 m-tiles a warp), so the plan takes one
    that has."""
    h, w, cin, cmid, cout, rd = shape
    plan = mbconv_plan(2, h, w, cin, cmid, cout, dtype, se_dim=rd)
    check_cluster_plan(plan, h, w, cin, cmid, rd, dtype)


def test_plan_refuses_an_empty_shape():
    with pytest.raises(ValueError, match="empty"):
        mbconv_plan(0, 16, 32, 128, 512, 128, torch.bfloat16)
