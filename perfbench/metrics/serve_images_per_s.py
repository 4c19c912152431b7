"""Images of every request completed in the window, over the window's
time (a synchronised start to the last request's completion)."""


def read(run):
    if run.cell.loop.KIND != "serve":
        return None
    return run.window["calls"] * run.cell.traffic["batch"] / run.window["seconds"]
