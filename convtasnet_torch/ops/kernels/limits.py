"""Launch limits of the CUDA kernels (csrc/), in one module with no imports.

The wrappers (tcn_block.py, tcn_block_bwd.py, stream_block.py) refuse a
CUDA tensor beyond these limits with a ValueError; `ConvTasNetConfig.
kernel_form` reads the same numbers to send such a config to the eager
chain before any launch, as the JAX package's gate sends it to XLA
(convtasnet_tpu/models/conv_tasnet.py:182-233), and models/streaming.
block_form reads `stream_limit` to send the stream step's blocks to their
library ops.

  KERNEL_WIDTH    B and H are multiples of it: the GEMMs tile 128 columns
                  (and a depth of 64); every wrapper checks both widths.
  GEMM_MAX_H      bf16 K3 and KB3 (csrc/tcn_gemm_sm90.cuh) stage 2 * H f32
                  norm vectors in hop::VEC_BYTES = 8192 bytes (K3 unfold);
                  f32 K3 / KB3 (SIMT tiles) have no H limit.
  DWCONV_MAX_SPAN the largest conv span K2 is held to on the card (its card
                  tests run it). K2's staged window (tcn_block.dw_plan) takes
                  min(br + span, P * br) rows of a channel slice as narrow as
                  16 bytes, so shared memory does not bind below ~14,000 rows.
  BWD_MAXP        KB2 is compiled for 1..8 taps: dw[P] of a thread's
                  channels stays in registers across the strip's rows.
  BWD_MAX_SPAN    the largest conv span KB2 is held to on the card (its card
                  tests run it); its dc ring (tcn_block.kb2_plan) holds the
                  span rounded up to 32-row chunks plus one chunk, 1,056
                  rows of 128 bytes at this limit, within a CTA's shared
                  memory.

K1 and KB1 on the bf16 TMA + wgmma pipeline (modes H_IN and H_DZ of
tcn_gemm_sm90.cuh) bring no limit of their own: the depth B runs through
the TMA ring whatever its length, and KB1 stages bn <= 256 f32 values of g2.
"""

KERNEL_WIDTH = 128
GEMM_MAX_H = 1024
DWCONV_MAX_SPAN = 4096
BWD_MAXP = 8
BWD_MAX_SPAN = 1024


def kernel_limit(B: int, H: int, P: int, X: int, bf16: bool, train: bool, Sc: int = 0):
    """Why the kernel chain cannot run a config with these widths on a card,
    or None when every kernel it launches admits it. `train` adds the
    backward kernels (KB2's taps and span); the largest dilation of the
    chain is 2 ** (X - 1). Sc > 0 (skip channels) takes the skip modes of
    K3, KFW, KB1, KW z and KF, built for bf16 only, whose column tiles
    lie wholly in x or in s."""
    if B % KERNEL_WIDTH or H % KERNEL_WIDTH:
        return f"B={B} and H={H} must be multiples of {KERNEL_WIDTH}"
    if Sc and Sc % KERNEL_WIDTH:
        return f"Sc={Sc} must be a multiple of {KERNEL_WIDTH}"
    if Sc and not bf16:
        return "the skip modes run bf16 activations only"
    if bf16 and H > GEMM_MAX_H:
        return f"H={H} exceeds the bf16 GEMM kernels' {GEMM_MAX_H}"
    span = (P - 1) * 2 ** (X - 1)
    if span > DWCONV_MAX_SPAN:
        return f"conv span {span} exceeds K2's halo limit {DWCONV_MAX_SPAN}"
    if train and P > BWD_MAXP:
        return f"P={P} exceeds KB2's {BWD_MAXP} taps"
    if train and span > BWD_MAX_SPAN:
        return f"conv span {span} exceeds KB2's halo limit {BWD_MAX_SPAN}"
    return None


# The stream chunk step's TCN-block kernel (csrc/tcn_stream_block.cu): one
# cluster of STREAM_CLUSTER CTAs per stream, each CTA H / 8 channels and
# B / 8 output columns, frames in tiles of STREAM_ROWS; compiled for the
# (B, H) of the streamable configs (the causal one's; each warp's n8 tiles
# are template arguments, so a width is one more instantiation), bf16 only.
STREAM_CLUSTER = 8
STREAM_ROWS = 16
STREAM_WIDTHS = ((256, 512),)
STREAM_SMEM = 232448  # a CTA's dynamic shared memory (hop::SMEM_LIMIT)


def stream_smem(B: int, H: int, P: int, span: int) -> int:
    """Bytes of shared memory of one CTA of the stream kernel (its Layout):
    in_w's and out_w's column slices and the x and e tiles, rows padded by
    16 bytes; the ring of span + 16 frames; the taps; four f32 affines; the
    two norms' exchanged pairs; the three exchanges' mbarriers (32 bytes)."""
    hc, bc, pad, rows = H // STREAM_CLUSTER, B // STREAM_CLUSTER, 8, STREAM_ROWS
    return (2 * (B * (hc + pad) + H * (bc + pad) + rows * (B + pad) + rows * (H + pad)
                 + (span + rows) * hc + P * hc)
            + 16 * hc + 2 * STREAM_CLUSTER * rows * 8 + 32)


def stream_limit(B: int, H: int, P: int, X: int, bf16: bool):
    """Why the stream kernel cannot run the blocks of a config with these
    widths, or None when it admits every dilation 1 .. 2 ** (X - 1)."""
    if not bf16:
        return "the stream block kernel runs bf16 activations only"
    if (B, H) not in STREAM_WIDTHS:
        return f"the stream block kernel is built for (B, H) in {STREAM_WIDTHS}"
    span = (P - 1) * 2 ** (X - 1)
    if stream_smem(B, H, P, span) > STREAM_SMEM:
        return f"conv span {span} overflows the stream kernel's shared-memory ring"
    return None
