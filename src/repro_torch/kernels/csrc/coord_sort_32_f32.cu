// coord_sort for 32-row register capacity, float input: K23's
// instance (one translation unit per capacity and dtype: they compile in
// parallel).
#include "coord_stat.cuh"

template RT_SORT_LAUNCH(32, float);
