// coord_sort for 64-row register capacity, __nv_bfloat16 input: K23's
// instance (one translation unit per capacity and dtype: they compile in
// parallel).
#include "coord_stat.cuh"

template RT_SORT_LAUNCH(64, __nv_bfloat16);
