// Error text for the status codes the kernels' C entries return.
#include <cuda_runtime.h>

extern "C" const char* l32_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
