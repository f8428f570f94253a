// The order-statistic template for a 32-row register capacity,
// int8 codes (K18 and K19) (one translation unit per capacity and type:
// they compile in parallel).
#include "order_stat.cuh"

template RT_OS_LAUNCH(32, int8_t, false);
template RT_OS_LAUNCH(32, int8_t, true);
