"""tools subpackage: the port's counterparts of the JAX package's scripts.

The stage probe (``probe``) and its pixel population (``population``);
float32 parity and kernel identity at scale (``parity_f32``,
``impl_identity``); the fault soak and the elastic soak (``fault_soak``,
``elastic_soak`` with its ``elastic_worker``); one request's trace
(``lt_request``); the fleet benches (``capacity_bench``, ``fleet_bench``);
joint parameter-space parity and FTV validation (``parity_paramspace``,
``validate_ftv``); the host-path benches (``feed_bench``, ``fetch_bench``,
``upload_bench``, ``host_path_bench``); the serving and observability
benches (``serve_bench``, ``batch_bench``, ``flight_overhead``,
``reqtrace_bench``, ``tune_bench``); the pod trace (``lt_trace``); the perf
gate over the card's records (``perf_gate``, ``records/``); the scale
tools (``run_segment_measured``, ``giga_run``, ``stream_assembly_bench``,
``change_stream_bench``, ``multihost_bench`` with ``pod_launch``,
``arch_speedup``) and the multi-index run (``multiindex_bench``); and their
shared helpers (``measure``).  Run each as ``python -m
land_trendr_tpu_torch.tools.<name>``; each runs on the card unless given
``--device cpu`` (the trace readers ``lt_request`` and ``lt_trace`` read
files only)."""
