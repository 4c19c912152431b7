"""Calls of the port's hand-written kernels a call of the run's loop: the
sum of the kernel wrappers' counters over the process
(`hygrid_tpu_torch/utils/profiling.py::counts`, each kernel under its name)
over the training steps or model forwards counted there, so that a change
of route shows.  HexCNN-small: 24 a step (1 plan_gather, 6 hex_conv_layer,
5 dgrad, 6 wgrad, 6 gn_relu_backward), 7 a request; HexUNet-small: 24 a
step, 6 a request.  None where the port has no counters or launched no
kernel (a run on the CPU)."""


def read(run):
    try:
        from hygrid_tpu_torch.utils.profiling import CALLS, counts
    except ImportError:
        return None
    c = counts()
    calls = c.get("train_step" if run.cell.loop.KIND == "train"
                  else "forward", 0)
    kernels = sum(v for k, v in c.items() if k not in CALLS)
    if not calls or not kernels:
        return None
    return kernels / calls
