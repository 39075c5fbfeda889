"""The work a frame or a training step needs, computed from its inputs:
the operations and bytes of each kernel and of the whole unit, the chip's
peaks, and roofline bounds. Frozen: a later change to the program is read
against the same work."""
