// Shared C entry of the port's kernel library: error text for the wrappers.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
