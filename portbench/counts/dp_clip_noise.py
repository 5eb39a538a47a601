"""Kernel 8 (`dp_clip_noise_kernel`) over a block of B gradient messages
of K floats: reads the messages and their int32 stream ids, writes the
released messages (B·(8K + 4) bytes; 21,504 B at B=256, K=10). Operations
an element: the draw's ~60 (two lowbias32 hash words, the 24-bit
uniforms, log, sqrt, cos, as `csrc/dp_noise.cu` counts them), the clip's
square, add and scale, the noise's multiply and add; a row: the norm's
square root, the ratio and its minimum."""


def count(rows: int, dim: int) -> tuple[float, float]:
    """(bytes, operations) of one launch over ``rows`` real messages."""
    return float(rows * (8 * dim + 4)), float(rows * (65 * dim + 3))
