"""tools subpackage: the port's counterparts of the JAX package's scripts.

The stage probe (``probe``) and its pixel population (``population``);
float32 parity and kernel identity at scale (``parity_f32``,
``impl_identity``); the fault soak and the elastic soak (``fault_soak``,
``elastic_soak`` with its ``elastic_worker``); one request's trace
(``lt_request``); the fleet benches (``capacity_bench``, ``fleet_bench``);
and their shared helpers (``measure``).  Run each as
``python -m land_trendr_tpu_torch.tools.<name>``; each runs on the card
unless given ``--device cpu``."""
