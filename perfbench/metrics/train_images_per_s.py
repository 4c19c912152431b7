"""Images of every training step completed in the window, over the
window's time (a synchronised start to the last step's completion)."""


def read(run):
    if run.cell.loop.KIND != "train":
        return None
    return run.window["calls"] * run.cell.traffic["batch"] / run.window["seconds"]
