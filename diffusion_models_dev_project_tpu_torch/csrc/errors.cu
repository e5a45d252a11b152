// Error text for the codes the kernels' C functions return: a cudaError_t,
// or minus the CUresult of a cuTensorMapEncodeTiled call that failed.
#include <cuda_runtime.h>
#include <stdio.h>

extern "C" const char* kernels_error_string(int code) {
  if (code < 0) {
    static thread_local char text[64];
    snprintf(text, sizeof text, "cuTensorMapEncodeTiled returned CUresult %d", -code);
    return text;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
