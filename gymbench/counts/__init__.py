"""Operation and byte counts of the port's kernels as functions of a
cell's shapes, and the H100's published peaks: the least time a kernel can
take, against which its device time is a roofline share."""
