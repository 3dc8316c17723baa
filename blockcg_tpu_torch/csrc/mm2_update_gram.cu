// Y = M1 B1 + M2 B2 on lanes-major (k, n) fields, with the Gram G = Y Y^T of
// the stored Y, in one pass over B1 and B2.
//
// Replaces the Pallas kernel blockcg_tpu/ops/fused.py mm2_update_gram. The
// kernel is update_gram.cuh's streaming update on two stacked input fields,
// and on bf16 fields with the fused Gram its tensor-core update_gram_mma
// (their designs, bounds and arithmetic are described there).
#include "update_gram.cuh"

// Y (k, n) = M1 B1 + M2 B2 with M1 and M2 k x kin (row stride kin), B1 and
// B2 (kin, n); G (k x k) = Y Y^T when G != nullptr (k <= 64), part then
// holds (max_blocks, k, k) and the launch uses at most max_blocks blocks.
// kc: stacked input rows a stage copies (ops/fused.py update_plan). Y may
// equal B1 when k == kin.
extern "C" int bcg_mm2_update_gram(const float* M1, const float* B1, const float* M2,
                                   const float* B2, float* Y, float* part, float* G, int k,
                                   int kin, long long n, int kc, int max_blocks, int device,
                                   cudaStream_t stream) {
  return dispatch<float, 2, false>(M1, B1, M2, B2, nullptr, Y, part, G, k, kin, n, kc,
                                   max_blocks, device, stream);
}

// The same on bf16 fields B1, B2 and Y, M1 and M2 f32 (held exactly: f32
// FMAs on the lifted fields), without the fused Gram (G must be null: the
// fused Gram, up to 64 rows, runs bcg_mm2_update_gram_mma).
extern "C" int bcg_mm2_update_gram_bf16(const float* M1, const bf16* B1, const float* M2,
                                        const bf16* B2, bf16* Y, float* part, float* G, int k,
                                        int kin, long long n, int kc, int max_blocks,
                                        int device, cudaStream_t stream) {
  return dispatch<bf16, 2, false>(M1, B1, M2, B2, nullptr, Y, part, G, k, kin, n, kc,
                                  max_blocks, device, stream);
}

// The same on bf16 fields on the tensor cores with the fused Gram
// (update_gram.cuh update_gram_mma), k <= 64: Y (k, n) = M1 B1 + M2 B2, M1
// and M2 f32 k x k, each split exactly into three bf16 pieces; G = Y Y^T of
// the stored bf16 Y, exactly symmetric. T and stages come from ops/fused.py
// update_gram_mma_plan; part holds (max_blocks, k, k). Y may equal B1.
extern "C" int bcg_mm2_update_gram_mma(const float* M1, const bf16* B1, const float* M2,
                                       const bf16* B2, bf16* Y, float* part, float* G, int k,
                                       long long n, int T, int stages, int max_blocks,
                                       int device, cudaStream_t stream) {
  return dispatch_mma<2>(M1, B1, M2, B2, nullptr, Y, part, G, k, n, T, stages, max_blocks,
                         device, stream);
}
