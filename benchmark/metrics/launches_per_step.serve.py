"""Kernels launched on the device per denoising step in the profiled window
(the requests' steps), an exact count of the trace's kernels."""


def read(observed):
    p = observed.get("profile")
    if p is None or not observed.get("denoising_steps"):
        return None
    return p.kernels / observed["denoising_steps"]
