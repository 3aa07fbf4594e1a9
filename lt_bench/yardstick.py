"""The benchmark's frozen yardstick: the kernel's bytes and the card's peaks.

:func:`segment_kernel_bytes` is the least traffic the fused segmentation
kernel needs for the pixels a cell lands: every input read once, and
written once each ``SegOutputs`` field that the tile program or its
fetch reads (the vertex and segment fields, ``rmse``, ``p_of_f`` and
``model_valid``; not ``fitted`` and ``despiked``, which no product of a
cell uses), at the output dtypes the kernel wrote when the benchmark was
defined.  It is frozen here, so any later kernel, whatever it reads
again, writes, leaves out or spends on padding rows, is held to the same
work.  Operations are not counted: the only count the program has is its
kernel's own counting instantiation, which a later kernel would change.
"""

from __future__ import annotations

__all__ = ["PEAKS", "peak", "segment_kernel_bytes"]

#: published peaks by ``torch.cuda.get_device_name()``: HBM bytes/s
#: (NVIDIA's H100 SXM data sheet, at the full 700 W)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str, key: str) -> "float | None":
    """The published peak ``key`` of the card named ``kind``, or None."""
    return PEAKS.get(kind, {}).get(key)


def segment_kernel_bytes(px: int, ny: int, max_segments: int, value_bytes: int = 4,
                         launches: int = 1) -> int:
    """Bytes ``launches`` launches over ``px`` pixels in all, of ``ny``
    years, must move.

    Read: the ``(NY,)`` years in the value dtype, once a launch; per
    pixel the ``NY`` values in the value dtype and the ``NY`` bool mask.
    Written, per pixel: ``n_vertices`` int32; ``vertex_indices`` int32
    and ``vertex_years``, ``vertex_src_vals``, ``vertex_fit_vals`` in the
    value dtype, ``NV = max_segments + 1`` each; ``seg_magnitude``,
    ``seg_duration``, ``seg_rate``, ``NM = max_segments`` each; ``rmse``
    and ``p_of_f``; ``model_valid`` one byte.
    """
    nv, nm = max_segments + 1, max_segments
    read = launches * ny * value_bytes + px * ny * (value_bytes + 1)
    per_px = 4 + nv * (4 + 3 * value_bytes) + nm * 3 * value_bytes + 2 * value_bytes + 1
    return read + px * per_px
