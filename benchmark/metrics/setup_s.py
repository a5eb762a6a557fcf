"""Set-up: process start to the window's start (imports, the kernels'
load or build, the weights, the program and its warm-up), seconds."""


def read(record):
    return record.setup_s
