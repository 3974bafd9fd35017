"""setup_s: seconds from the process's start to the window's start:
imports, the device, loading or compiling the programs, building the first
request and its capped warm-up solve."""


def read(run):
    return run.setup_s
