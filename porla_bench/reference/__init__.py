"""The benchmark's plain reference of the porla protocol.

Python integers and NumPy only. It imports nothing of `porla_tpu_torch`,
of `porla_tpu` or of JAX, and takes nothing that the program made: from a
configuration, a data seed and the audit seeds it works out again the
blocks, the server's levels (data planes and the discrete logarithms of
the MAC planes) and every audit reply, and `check` holds what the program
produced against them.
"""
