// Error text for the codes the other entry points return.
#include <cuda_runtime.h>

extern "C" const char* cfd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
