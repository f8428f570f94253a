// coord_stat for 64-row register capacity, __nv_bfloat16 input: K1's
// plain and K5's masked instance (one translation unit per capacity
// and dtype: they compile in parallel).
#include "coord_stat.cuh"

template RT_CS_LAUNCH(64, __nv_bfloat16, false, false);
template RT_CS_LAUNCH(64, __nv_bfloat16, true, false);
