// K5's odd-even network kernel for a 32-row register capacity,
// __nv_bfloat16 input (one translation unit per capacity and dtype: they compile
// in parallel).
#include "coord_stat.cuh"

template RT_CS_LAUNCH(32, __nv_bfloat16, true);
