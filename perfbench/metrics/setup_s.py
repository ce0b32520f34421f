"""Process start to the first timed call: data, whitener fit, build,
serving index and warm-up."""


def read(res):
    return res["setup_s"]
