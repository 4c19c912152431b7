"""Hand-written Hopper (sm_90a) kernels of the PyTorch port.

* ``resample.plan_gather`` — ``csrc/plan_gather.cu`` (replaces
  ``hygrid_tpu/kernels/resample_pallas.py::_resample_kernel``);
* ``conv_stack.hex_conv_layer`` — ``csrc/hex_conv_layer.cu`` (replaces
  ``hygrid_tpu/kernels/conv_pallas.py::_stack_layer_kernel`` and
  ``::_stack_layer_kernel_banded``; bfloat16 on the tensor cores; GN
  statistics summed in the conv pass's epilogue);
* ``conv_stack.gn_relu_backward`` — ``csrc/gn_backward.cu``, the GN/ReLU
  tail's backward of a GN layer (the counterpart of the reference's
  ``jax.vjp`` of ``conv_pallas.py::_make_post`` under XLA): one
  cooperative launch walking the waves ``conv_stack.gn_backward_plan``
  chooses;
* ``conv_stack.hex_conv_layer_dgrad`` (the same conv pass on the adjoint
  tap table) and ``conv_stack.hex_conv_layer_wgrad``
  (``csrc/hex_conv_wgrad.cu``) — together they replace
  ``conv_pallas.py::_stack_layer_bwd_kernel``;
* ``resample_shift.shift_resample`` — ``csrc/shift_resample.cu`` (replaces
  ``hygrid_tpu/kernels/resample_shift.py::_shift_kernel_full`` and
  ``::_shift_kernel_banded``);
* ``conv_stack.hex_conv_fused_stack`` — ``csrc/hex_conv_fused_stack.cu``
  (replaces ``conv_pallas.py::_fused_stack_kernel``);
* ``conv_single.hex_conv_single`` — ``csrc/hex_conv_single.cu`` (replaces
  ``conv_pallas.py::_conv_kernel`` and ``::_conv_kernel_banded``, the
  single-op conv of ``hex_conv2d(impl="pallas")``);
* ``pool.hex_max_pool`` — ``csrc/hex_pool.cu``, the strided NHWC hex
  max-pool and its backward from a tie mask (replaces no TPU kernel:
  ``hygrid_tpu``'s pools are XLA; ``nn.functional.hex_pool2d`` routes the
  models' 2 x 2 max-pools of CUDA tensors to it).

Importing these modules builds nothing: ``_build.load_library`` compiles
the CUDA sources at the first kernel launch.  Each forward wrapper calls
its ``hygrid`` op (``_ops.py``), which runs the kernel's plain PyTorch
version on a CPU tensor and launches the kernel on a CUDA tensor; the
backward kernels are called directly, but for the pool's, an op too.
"""
