"""Plain reference of a CORE deployment: GF(2^8), the RS(n, k) generator,
the CORE group encoding and the frozen PUT-payload rule. Imports nothing
of the program."""
