"""Set-up seconds: from the process's start (before torch is imported)
to the end of the warm-up, the library's build, the model, the inputs and
the warm-up calls included."""


def read(run):
    return run.setup_s
