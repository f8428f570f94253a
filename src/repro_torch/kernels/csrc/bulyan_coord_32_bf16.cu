// bulyan_coord for 32-row register capacity, __nv_bfloat16 input (one
// translation unit per capacity and dtype: they compile in parallel).
#include "bulyan_coord.cuh"

template void bulyan_coord_launch<32, __nv_bfloat16>(
    const void*, const float*, float*, int, long long, long long, int, int,
    cudaStream_t);
