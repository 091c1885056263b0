"""The kernel-name patterns that the per-layer readers sum over: substrings
of the device kernels' names in a trace.  The hand-written kernels are the
port's (``csrc/gather.cu``, ``csrc/scatter.cu``); the sorts are the radix
sorts that ``torch.sort`` launches on the scatters' long key streams."""

# K4: the fused and plain gathers and the row interleave of the table slice.
K4 = ("take_wsum_kernel", "take_kernel", "interleave_kernel<")
# K1's fused entry and K2: the row walks, their tier lists, and the grads'
# and records' passes.
SCATTER = ("rows_kernel", "tier_kernel", "interleave_grads_kernel",
           "dense_pack_kernel", "gather_records_kernel",
           "form_records_kernel")
# The scatters' preparation: stable radix sorts of the keys and run starts.
SORT = ("RadixSort", "run_starts_kernel")
