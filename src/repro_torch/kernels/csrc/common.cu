// Helpers shared by the kernels' C interface.

#include <cuda_runtime.h>

// The message for an error code that a kernel entry point returned.
extern "C" const char* mist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
