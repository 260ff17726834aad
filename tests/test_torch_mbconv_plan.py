"""``ops/mbconv.py::mbconv_plan``: which launches kernel 2 takes for a block,
decided from its shape alone (pure Python, so it runs on the CPU).

The cluster path (``csrc/mbconv.cu``) keeps one image's expanded map in the
shared memory of a thread-block cluster; a shape whose map no cluster of
16 CTAs can hold, or whose channels are not multiples of 8, takes the
three launches of ``csrc/mbconv_tiled.cu``."""

import pytest
import torch

from p4fr_tpu_torch.ops.mbconv import (
    MAX_TILES,
    MAX_WIDTH,
    RING_MAX,
    SMEM_LIMIT,
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
    assert plan.cluster in (1, 2, 4, 8, 16) and len(plan.slices) == plan.cluster
    start = 0
    for s, width in plan.slices:
        assert s == start and width > 0 and s % 8 == 0 and width % 8 == 0
        start += width
    assert start == cmid
    assert plan.width == max(width for _, width in plan.slices)
    assert max(wd for _, wd in plan.slices) - min(wd for _, wd in plan.slices) <= 8
    wm = plan.warp_rows
    mpw, npw = launch_a_tiles(h * w, plan.width, wm)
    assert 16 % wm == 0 and mpw in (2, 4) and 2 <= npw <= MAX_TILES
    assert wm * mpw * 16 >= h * w and (16 // wm) * npw * 8 >= plan.width
    assert w <= MAX_WIDTH
    assert 2 <= plan.stages <= RING_MAX
    assert (plan.smem, plan.stages) == launch_a_layout(h, w, cin, plan.width, plan.cluster,
                                                       se_dim, wm, dtype == torch.bfloat16)
    assert plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("batch", [256, 32])
@pytest.mark.parametrize("name", FLAGSHIP)
def test_flagship_shapes_take_the_cluster_path(name, batch, dtype):
    (h, w, cin, cmid, cout, rd), cluster = FLAGSHIP[name]
    plan = mbconv_plan(batch, h, w, cin, cmid, cout, dtype, se_dim=rd)
    check_cluster_plan(plan, h, w, cin, cmid, rd, dtype)
    assert plan.cluster == cluster


# (H, W, Cin, Cmid, Cout, SE hidden) -> the path and cluster size the design
# gives it, in both types
ROUTES = [
    # EfficientASTER's 256x1024 input: the stage-4 map is 16x64x960x4 B =
    # 3.9 MB an image, and stage 3's 2 MB with 1024 pixels of x in the ring
    ((16, 64, 160, 960, 160, 40), "tiled", 0),
    ((16, 64, 128, 512, 128, 32), "tiled", 0),
    ((8, 32, 256, 1536, 256, 64), "cluster", 16),
    # the small ragged shapes of tests/test_torch_kernels.py (11x19)
    ((11, 19, 24, 96, 40, 6), "cluster", 1),
    ((11, 19, 32, 128, 32, 0), "cluster", 1),
    ((11, 19, 40, 160, 40, 10), "cluster", 2),
    ((11, 19, 80, 320, 80, 20), "cluster", 4),
    # channels that are not multiples of 8: the cluster kernels move 16-byte
    # vectors of whole 8-channel groups
    ((11, 19, 12, 48, 12, 3), "tiled", 0),
]


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("shape,path,cluster", ROUTES,
                         ids=["aster_s4", "aster_s3", "aster_s5", "ragged_c1", "ragged_c1_no_se",
                              "ragged_c2", "ragged_c4", "not_multiple_of_8"])
def test_plan_routes_each_shape(shape, path, cluster, dtype):
    h, w, cin, cmid, cout, rd = shape
    plan = mbconv_plan(3, h, w, cin, cmid, cout, dtype, se_dim=rd)
    assert (plan.path, plan.cluster) == (path, cluster)
    if path == "cluster":
        check_cluster_plan(plan, h, w, cin, cmid, rd, dtype)
    else:
        assert plan.slices == () and plan.smem == 0


@pytest.mark.parametrize("name", FLAGSHIP)
def test_plan_depends_on_the_shape_alone(name):
    """The batch never changes the plan (persistent clusters walk it)."""
    (h, w, cin, cmid, cout, rd), _ = FLAGSHIP[name]
    plans = {mbconv_plan(b, h, w, cin, cmid, cout, torch.bfloat16, se_dim=rd)
             for b in (1, 7, 32, 256, 1000)}
    assert len(plans) == 1


def test_plan_refuses_an_empty_shape():
    with pytest.raises(ValueError, match="empty"):
        mbconv_plan(0, 16, 32, 128, 512, 128, torch.bfloat16)
