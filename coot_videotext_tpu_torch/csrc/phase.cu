// Phase marks: one empty kernel per boundary of a train step, named by the
// phase it opens, so that a device trace splits a captured step (one
// unbroken stream of kernels when its graph replays) into its forward,
// backward and optimizer. The step launches them on its stream
// (ops/phase.py), so they are captured into the train graphs with the rest.
//
// They lie outside the `coot` namespace on purpose: a trace's reader names
// the program's own kernels by that namespace, and a mark does no work.

#include <cuda_runtime.h>

__global__ void phase_mark_forward() {}
__global__ void phase_mark_backward() {}
__global__ void phase_mark_optimizer() {}
__global__ void phase_mark_end() {}

// phase: 0 forward, 1 backward, 2 optimizer, 3 end (ops/phase.py PHASES).
extern "C" int coot_phase_mark(int phase, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0: phase_mark_forward<<<1, 1, 0, st>>>(); break;
    case 1: phase_mark_backward<<<1, 1, 0, st>>>(); break;
    case 2: phase_mark_optimizer<<<1, 1, 0, st>>>(); break;
    case 3: phase_mark_end<<<1, 1, 0, st>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
