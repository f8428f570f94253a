// bulyan_coord for 32-row register capacity, float input (one
// translation unit per capacity and dtype: they compile in parallel).
#include "bulyan_coord.cuh"

template void bulyan_coord_launch<32, float>(
    const void*, const float*, float*, int, long long, long long, int, int,
    cudaStream_t);
