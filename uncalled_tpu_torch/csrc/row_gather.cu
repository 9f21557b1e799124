// Per-row and shared-table gather of the classic step (Hopper, sm_90a).
//
// Replaces uncalled_tpu/ops/mxu_gather.py:_gather_kernel (the monolithic
// one-hot MXU gather, N <= 4096) and :_gather_kernel_chunked (the same
// function with the contraction walked in HC-row chunks, N > 4096), both
// reached through _gather_i32 by row_gather / shared_gather /
// row_gather_fields from engine._event_step, which now also gathers its
// per-slot fields through row_gather_cols.
//
//   out[f, b, k] = col_f[b, clamp(idx[b, k], 0, N-1)]
//
// the column-descriptor gather of gather.cuh: a column segment with batch
// stride 0 is shared by every row (a shared table, or the classic step's
// thresholds beside its per-read probs).  The payload is any 32-bit
// pattern (f32 fields move as their bits, so NaN payloads and -0.0
// survive) or a bool byte.
//
// Bound on the card: bytes, and for scattered rows the L2's latency.  The
// TPU needed the one-hot matmul, the W=8 layout and the H-chunking because
// its gathers were slow per index and its tables had to fit VMEM; the card
// gathers directly, and every size N takes the same kernel.  One thread
// per (b, k) reads its row once, with every field's load in flight before
// its stores (16-byte loads for four side-by-side 32-bit fields, as in the
// [B, 256, 4] prob rows), from columns that stay where they lie, so the
// step packs nothing before a call.

#include "gather.cuh"

extern "C" int row_gather_cols_i32(const long long* meta, const void* idx,
                                   void* out, void* stream) {
  return gather_cols_launch(meta, idx, out, stream);
}
