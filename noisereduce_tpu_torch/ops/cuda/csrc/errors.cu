// Name of a CUDA error code returned by the kernel entries, for the Python
// wrappers' exceptions.
#include <cuda_runtime.h>

extern "C" const char* nr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
