"""Which device operations of a trace are the analog kernels: the
kernels of the port's analog libraries (``csrc/fake_analog.cu``,
``analog_mac.cu``, ``xnor_gemm.cu``) and their split-K reduce passes,
which live in an anonymous namespace; and which are copies or sets rather
than kernel launches."""

ANALOG = ("fake_kernel", "mac_kernel", "xnor_kernel",
          "(anonymous namespace)::reduce_kernel")
NOT_LAUNCHES = ("Memcpy", "Memset")


def is_analog(name: str) -> bool:
    return any(k in name for k in ANALOG)


def is_launch(name: str) -> bool:
    return not name.startswith(NOT_LAUNCHES)
