"""The port's host core: a copy of the JAX package's C++ core, built with g++
at first use and bound with ctypes."""
