"""The port's kernels: CUDA C++ sources in ``csrc/``, their ctypes bindings
(``mriq``, ``flash_attention``, ``swiglu``), the plain versions (``ref``) and
the dispatching public wrappers (``ops``)."""
