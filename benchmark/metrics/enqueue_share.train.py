"""The host's time from the train step's call to its return over the step's
synchronised wall time from the same call, summed over the traced run's probe
steps, in percent."""


def read(observed):
    if not observed.get("step_wall_s"):
        return None
    return 100.0 * observed["enqueue_s"] / observed["step_wall_s"]
