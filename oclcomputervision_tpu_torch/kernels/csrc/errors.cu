// Error strings for the C entry points of libocvk: each returns
// cudaGetLastError() as an int, and the Python wrapper asks for its text.
#include <cuda_runtime.h>

extern "C" const char* ocvk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
