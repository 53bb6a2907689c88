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


def _edited_files(kernel):
    return {fname for edits in cb.KERNELS[kernel][1].values() for fname, _, _ in edits}


def test_teacher_variants_edit_the_wgmma_tile():
    """The teacher's variants patch the field tile (which holds its launch
    and its tile walk too) of the kernel they build, and the bf16 packing it
    shares with the student's tile (no_cvt); the whole-ray kernel has its
    no_glue variant."""
    assert cb.KERNELS["teacher"][0] == "nerf_forward.cu"
    assert _edited_files("teacher") == {"nerf_wgmma.cuh", "r2l_wgmma.cuh"}
    assert {"no_loads", "no_products", "no_trig", "no_views", "no_epilogues",
            "block_barrier"} <= set(cb.KERNELS["teacher"][1])
    assert cb.KERNELS["frame"][0] == "nerf_frame.cu" and "no_glue" in cb.KERNELS["frame"][1]


def test_int8_variants_edit_the_wgmma_tiles():
    """The int8 kernels' variants patch the wgmma tiles they run on: the
    student's int8 body in csrc/r2l_wgmma.cuh and the conversions of
    csrc/int8_epilogue.cuh, the field tile and the int8 epilogues of
    csrc/nerf_int8.cu."""
    assert cb.KERNELS["serve_int8"][0] == "r2l_int8.cu"
    assert _edited_files("serve_int8") == {"r2l_wgmma.cuh", "int8_epilogue.cuh"}
    assert cb.KERNELS["teacher_int8"][0] == "nerf_int8.cu"
    assert _edited_files("teacher_int8") == {"nerf_wgmma.cuh", "nerf_int8.cu",
                                             "int8_epilogue.cuh"}
    for kernel in ("serve_int8", "teacher_int8"):
        assert {"shipped", "no_loads", "no_products", "no_epilogues", "first_conversions",
                "ring_2"} <= set(cb.KERNELS[kernel][1])
