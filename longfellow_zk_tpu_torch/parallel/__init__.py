"""The multi-card paths: the port of the JAX package's parallel/ package and
of the mesh= arguments of its provers, over torch.distributed (one
process a card; NCCL on the card, gloo on the CPU).

  - launch.py: `spawn`, the ranks of a run, each in a process group;
  - mesh.py: `Mesh` / `make_mesh`, the row and copy partitions, the
    collectives, `sharded_rs_encode`;
  - sumcheck_sharded.py: the copy rounds' coefficients with the copy
    axis sharded;
  - ntt_sharded.py: `ShardedNTT`, the four-step NTT with one
    all_to_all;
  - smoke.py: the paths at full size on N cards, each held to its golden
    and its one-card run (`python3 -m
    longfellow_zk_tpu_torch.parallel.smoke --world N`).

The provers take a mesh too: sumcheck/prover.py (copies), ligero/
prover.py and zk/prover.py (tableau rows), zk/batch.py (lanes).  No new
kernel: each rank's work is the one-card kernels'; the traffic between
cards is NCCL's, as the JAX package left it to XLA's collectives.
"""
