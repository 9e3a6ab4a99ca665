"""render_sample: blocking device-to-host waits a traced frame: stream,
event, device and context synchronizes and synchronous copies among the
CUDA API calls (cuda*, cu*)."""

BLOCKING = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy", "cudaMemcpy2D", "cuStreamSynchronize", "cuCtxSynchronize",
            "cuEventSynchronize", "cuMemcpy", "cuMemcpyDtoH", "cuMemcpyDtoH_v2"}


def read(t):
    if not t.runtime_in_window():
        return None
    return sum(1 for name, _, _ in t.runtime_in_window() if name in BLOCKING) / len(t.frames)
