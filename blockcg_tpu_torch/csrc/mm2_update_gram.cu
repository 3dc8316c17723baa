// Y = M1 B1 + M2 B2 on lanes-major (k, n) fields, with the Gram G = Y Y^T of
// the stored Y, in one pass over B1 and B2.
//
// Replaces the Pallas kernel blockcg_tpu/ops/fused.py mm2_update_gram. The
// kernel is update_gram.cuh's streaming update on two stacked input fields
// (its design, bound and arithmetic are described there).
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

// The same on bf16 fields B1, B2 and Y (M1 and M2 stay f32 and are rounded to
// bf16 where they are staged; G is f32, of the stored bf16 Y).
extern "C" int bcg_mm2_update_gram_bf16(const float* M1, const bf16* B1, const float* M2,
                                        const bf16* B2, bf16* Y, float* part, float* G, int k,
                                        int kin, long long n, int kc, int max_blocks,
                                        int device, cudaStream_t stream) {
  return dispatch<bf16, 2, false>(M1, B1, M2, B2, nullptr, Y, part, G, k, kin, n, kc,
                                  max_blocks, device, stream);
}
