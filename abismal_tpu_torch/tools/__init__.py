"""Device tools of the port (↔ the JAX package's tools/): cut bisection of
the fused programs (profile_stage12, profile_stage12pe), the event
program's timing (profile_stage1), a per-kernel device timeline
(trace_ops), the end-to-end stage table (profile), the 1 Gb measurement
(scale_device), the fallback sweep (fallback_sweep) and the extension
check against the host oracle (debug_ext).  Each runs as
`python -m abismal_tpu_torch.tools.<name>`, on the card unless given
`--device cpu`; their shared inputs are in _workload."""
