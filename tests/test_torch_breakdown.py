"""chip_breakdown.py's variants against the sources they edit: each edit's
text occurs exactly once in its file, after the variant's edits before it,
so that a change to a kernel source that a variant no longer matches fails
here on the CPU and not only on the card."""
import pytest

import chip_breakdown as cb
from efficient_nerf_tpu_torch.ops import _build

VARIANTS = [(kernel, name) for kernel, (_, variants) in sorted(cb.KERNELS.items())
            for name in variants]


@pytest.mark.parametrize("kernel,name", VARIANTS, ids=[f"{k}-{n}" for k, n in VARIANTS])
def test_variant_edits_match_their_sources_once(kernel, name):
    source, variants = cb.KERNELS[kernel]
    edits = variants[name]
    if isinstance(edits, tuple):  # a variant that builds another source
        source, edits = edits
    assert (_build.CSRC / source).is_file()
    texts = cb.variant_sources(edits, _build.CSRC)
    for fname, _, new in edits:
        assert new in texts[fname]
    assert name != "shipped" or not edits


def test_teacher_variants_edit_the_wgmma_tile():
    """The teacher's variants patch the new field tile (and its launch), and
    the whole-ray kernel has its no_glue variant."""
    files = {fname for edits in cb.KERNELS["teacher"][1].values() for fname, _, _ in edits}
    assert {"nerf_wgmma.cuh", "nerf_forward.cu"} <= files
    assert {"no_loads", "no_products", "no_trig", "no_views", "no_epilogues",
            "block_barrier"} <= set(cb.KERNELS["teacher"][1])
    assert cb.KERNELS["frame"][0] == "nerf_frame.cu" and "no_glue" in cb.KERNELS["frame"][1]
