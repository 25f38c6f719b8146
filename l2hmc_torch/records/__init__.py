"""The port's record drivers: the U(1) flagship (`run_u1_flagship`), its
two companion records (`quality`) and the SU(3) 8^4 flowed-loss run
(`run_su3_flowloss`), each the counterpart of a JAX driver or command under
the repo's `records/`. The port's own results sit in `h100/`."""
