// dit_block_tp_f32: the f32 instances of dit_block_tp.cu's TP kernel (rows
// 6, 7 and 8 of a float32 model, and row 9 on the same instance) and their
// entry points, tp_attn_f32, tp_mlp_f32, mlp_branch_f32 and
// dit_block_tp_resident_ctas_f32. A library of its own, so that nvcc builds
// it beside the bf16 kernels, at the same time.
#define DIT_BLOCK_TP_F32 1
#include "dit_block_tp.cu"
