"""SURF core: tasks, the unrolled U-DGD network (``unroll``) and the
public solve API (``surf``)."""
