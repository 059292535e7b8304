// Error text for the cudaError_t codes that the kernels' C functions return.

#include <cuda_runtime.h>

extern "C" const char* nqt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
