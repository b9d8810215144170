// Error reporting for the C entry points: each returns cudaGetLastError()
// after its launch, and the Python wrapper turns a nonzero code into an
// exception with this message.
#include "common.cuh"

WEALY_API const char* wealy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
