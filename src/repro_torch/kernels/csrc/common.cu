// Error reporting shared by the kernel entry points: each entry point
// returns cudaGetLastError() after its launch, and the Python wrapper
// turns a non-zero code into a message through qs_error_string.
#include <cuda_runtime.h>

extern "C" const char* qs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
