"""Ligero prover: commit (RS-encoded tableau + Merkle column hashes) and
prove (low-degree / linear / quadratic tests + column openings).

Port of the JAX package's ligero/prover.py, semantic twin of reference
lib/ligero/ligero_prover.h:34-356.  Every tableau row group with the same
input width is encoded in one batched RS call (K4 NTTs and K1 scalings);
the tableau stays on the device.  The commit serializes the extension
columns on the device (K1 from Montgomery, then the first kBytes of each
element, the transpose to columns and the nonces in front), hashes each
column with K8 and builds the Merkle heap level by level (merkle_dev);
only the heap crosses to the host, for the column openings (the JAX
package's _commit_full_fn, ligero/prover.py:268, with one flow for every
size).  The responses (y_ldt / y_dot / y_quad) are row combinations in K1 and
column sums in K3 (`_responses`); the rest of the proof, its challenges,
the vector A (K12), the transcript writes and the column choice (K9), runs
on the card in zk/fused.ligero_finish_dev, and `assemble` fills the proof
from the prover's one fetch.  The host draws (ligero/transcript.py) and
inner_product_vector (ligero/param.py) stay for the verifier.

A LigeroProver commits the tableaus of B lanes at once (the proofs of a
batch, zk/batch.py; one proof is one lane): their rows go through the
RS kernels as one stack, their columns through one K8 launch and their
Merkle heaps level by level in one launch a level (the jax.vmap of the
JAX package's _commit_full_fn, zk/batch.py:124), one device-to-host copy
brings every heap back, and each lane keeps its own MerkleCommitment.

With a mesh (parallel/mesh.py; the JAX package's mesh=, ligero/prover.py
:61-75, :185-208, which shards the block-width rows of its commit) the
tableau's rows go over the mesh's rows axis (D ranks): each rank encodes
its share of the block-width rows (parallel/mesh.sharded_rs_encode) and
the encodings are all-gathered, so every rank holds the whole tableau;
each rank hashes its share of the block_ext columns with K8, the leaves
are all-gathered and every rank builds the heap; the responses' sums
over rows run on each rank's share of the rows and the D partial sums
are summed as field elements (Mesh.sum).  The proof is the one card's,
byte for byte, on every rank.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from ..merkle.merkle import MerkleCommitment, NONCE_LEN
from ..merkle.merkle_dev import merkle_heap
from ..merkle.sha256_dev import sha256_msgs
from ..parallel.mesh import mesh_device, sharded_rs_encode
from .param import LigeroParam, LigeroProof


class LigeroProver:
    def __init__(self, p: LigeroParam, F, rs_factory: Callable, device=None,
                 mesh=None):
        """rs_factory(n, m) -> encoder with .interpolate([..., n, N])
        returning [..., m, N] on `device` (the mesh's, with a mesh)."""
        self.p = p
        self.F = F
        self.rs_factory = rs_factory
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.mcs: List[MerkleCommitment] = []  # one a lane
        self.tableau = None  # [B, nrow, block_enc, N] Montgomery limbs
        self.aext_rs = None  # the dot test's (block, dblock) encoder

    # ------------------------------------------------------------------

    def _commit_prep(self, W_host: Sequence, subfield_boundary: int, lqc,
                     rng):
        """Host-side tableau-row construction (witness blocks, blinding
        rows, quadratic triples, nonces), consuming `rng` in the JAX
        package's order.  Returns host ints: (block rows, dblock rows,
        nonces)."""
        p, F = self.p, self.F
        for i in range(subfield_boundary):
            assert F.in_subfield(W_host[i]), "element not in subfield"

        zero = F.of_scalar(0)

        def rand_row(n):
            return [F.sample(rng.bytes) for _ in range(n)]

        def rand_subfield_row(n):
            return [F.sample_subfield(rng.bytes) for _ in range(n)]

        # --- block-width rows (ildt, witness, quadratic) ---
        block_rows = []  # list of [block] host scalars
        # ildt
        block_rows.append(rand_row(p.block))
        # witness rows
        for i in range(p.nwrow):
            subfield_only = (i + 1) * p.w <= subfield_boundary
            blinds = rand_subfield_row(p.r) if subfield_only else rand_row(p.r)
            chunk = list(W_host[i * p.w : min((i + 1) * p.w, p.nw)])
            chunk += [zero] * (p.w - len(chunk))
            block_rows.append(blinds + chunk)
        # quadratic rows x, y, z
        qx, qy, qz = [], [], []
        for i in range(p.nqtriples):
            bx, by, bz = rand_row(p.r), rand_row(p.r), rand_row(p.r)
            cx = [zero] * p.w
            cy = [zero] * p.w
            cz = [zero] * p.w
            for j in range(p.w):
                iw = j + i * p.w
                if iw >= p.nq:
                    break
                l = lqc[iw]
                assert W_host[l.z] == F.mul_i(W_host[l.x], W_host[l.y]), \
                    "invalid quadratic constraints"
                cx[j] = W_host[l.x]
                cy[j] = W_host[l.y]
                cz[j] = W_host[l.z]
            qx.append(bx + cx)
            qy.append(by + cy)
            qz.append(bz + cz)
        block_rows += qx + qy + qz

        # --- dblock-width rows (idot, iquad) ---
        # dot-blinding row constrained so the W part sums to zero
        # (ligero_prover.h:188-194): subtract the W-part sum from W[0]
        idot = rand_row(p.dblock)
        s = zero
        for v in idot[p.r : p.r + p.w]:
            s = F.add_i(s, v)
        idot[p.r] = F.sub_i(idot[p.r], s)
        iquad = rand_row(p.dblock)
        for j in range(p.w):
            iquad[p.r + j] = zero

        nonces = [rng.bytes(NONCE_LEN) for _ in range(p.block_ext)]
        return block_rows, [idot, iquad], nonces

    def commit(self, preps) -> List[bytes]:
        """Encode the lanes' tableaus and Merkle-commit their columns
        (ligero_prover.h:58-79), every lane in the same launches; preps
        are _commit_prep's results, one a lane.  Returns the lanes' roots
        (the caller writes each to its transcript)."""
        p, F, dev = self.p, self.F, self.device
        B = len(preps)

        def rows(k, width):
            vals = [v for prep in preps for row in prep[k] for v in row]
            return F.to_limbs(vals, dev).reshape(
                (B * len(preps[0][k]), width) + F.elt_shape)

        rs_b, rows_b = self.rs_factory(p.block, p.block_enc), rows(0, p.block)
        if self.mesh is None:
            enc_b = rs_b.interpolate(rows_b)
        else:
            enc_b = self.mesh.gather(sharded_rs_encode(
                rs_b, self.mesh, self.mesh.shard(rows_b)), rows_b.shape[0])
        enc_b = enc_b.reshape((B, -1, p.block_enc) + F.elt_shape)
        enc_d = self.rs_factory(p.dblock, p.block_enc).interpolate(
            rows(1, p.dblock)).reshape((B, 2, p.block_enc) + F.elt_shape)
        # made here, with its uploads, so that the responses upload nothing
        self.aext_rs = self.rs_factory(p.block, p.dblock)
        # row order [ildt, idot, iquad, iw.., iq..]
        self.tableau = torch.cat([enc_b[:, :1], enc_d, enc_b[:, 1:]], dim=1)
        # the leaves: H(nonce || natural little-endian bytes of the
        # column), each element kBytes of its [4 N] bytes (a view)
        nat = F.from_mont(self.tableau[:, :, p.dblock :].contiguous())
        cols = F.natural_limbs_to_bytes_dev(nat).transpose(1, 2)
        nonce_t = torch.frombuffer(
            bytearray(b"".join(n for prep in preps for n in prep[2])),
            dtype=torch.uint8).to(dev)
        msgs = torch.cat([nonce_t.reshape(B, p.block_ext, NONCE_LEN),
                          cols.reshape(B, p.block_ext, -1)], dim=2)
        if self.mesh is None:
            leaves = sha256_msgs(msgs.reshape(B * p.block_ext, -1))
        else:
            mine = self.mesh.shard(msgs, dim=1)
            leaves = self.mesh.gather(
                sha256_msgs(mine.reshape(-1, msgs.shape[2])).reshape(
                    B, mine.shape[1], -1), p.block_ext, dim=1)
        heaps = merkle_heap(leaves.reshape(B, p.block_ext, -1)).cpu().numpy()
        self.mcs = [MerkleCommitment(p.block_ext) for _ in range(B)]
        return [mc.commit_heap(heap, prep[2])
                for mc, heap, prep in zip(self.mcs, heaps, preps)]

    # ------------------------------------------------------------------

    def _responses(self, u_ldt, A_rows, u_quad):
        """The three Ligero tests (ligero_prover.h:283-350) over the
        resident tableaus, every lane at once (u_ldt [B, nwqrow, N], A_rows
        [B, nwqrow, block, N], u_quad [B, nqtriples, N]): (y_ldt, y_dot,
        y_quad) tensors [B, block or dblock, N]."""
        p, F, T = self.p, self.F, self.tableau
        B = T.shape[0]
        # the rows summed over: this rank's share with a mesh (the
        # witness rows, the quadratic triples), else all
        w0, w1 = (0, p.nwqrow) if self.mesh is None else \
            self.mesh.bounds(p.nwqrow)
        q0, q1 = (0, p.nqtriples) if self.mesh is None else \
            self.mesh.bounds(p.nqtriples)

        def rowsum(t, width):
            if self.mesh is not None and t.shape[1] == 0:
                return F.zeros((B, width), T.device)  # a rank without rows
            return F.lazy_sum(t, 1)

        wrows = T[:, p.iw + w0 : p.iw + w1]
        # low-degree test: ildt + sum_i u_i * w_i over [0, block)
        t0 = F.mul(wrows[:, :, : p.block].contiguous(),
                   u_ldt[:, w0:w1, None])
        s_ldt = rowsum(t0, p.block)
        # dot test: idot + sum_i Aext_i o w_i over [0, dblock)
        a_rows = A_rows[:, w0:w1]
        aext = sharded_rs_encode(
            self.aext_rs, self.mesh,
            a_rows.reshape((-1, p.block) + F.elt_shape)).reshape(
                a_rows.shape[:2] + (p.dblock,) + F.elt_shape)
        t1 = F.mul(aext, wrows[:, :, : p.dblock].contiguous())
        s_dot = rowsum(t1, p.dblock)
        # quadratic test: iquad + sum_i u_i * (z_i - x_i o y_i)
        nqt = p.nqtriples
        xr = T[:, p.iq + q0 : p.iq + q1, : p.dblock].contiguous()
        yr = T[:, p.iq + nqt + q0 : p.iq + nqt + q1, : p.dblock].contiguous()
        zr = T[:, p.iq + 2 * nqt + q0 : p.iq + 2 * nqt + q1,
               : p.dblock].contiguous()
        t2 = F.mul(F.sub(zr, F.mul(xr, yr)), u_quad[:, q0:q1, None])
        s_quad = rowsum(t2, p.dblock)
        if self.mesh is not None:
            # the D ranks' partial sums, summed as field elements
            s_ldt, s_dot, s_quad = torch.split(self.mesh.sum(
                F, torch.cat([s_ldt, s_dot, s_quad], dim=1)),
                [p.block, p.dblock, p.dblock], dim=1)
        y_ldt = F.add(T[:, p.ildt, : p.block].contiguous(),
                      s_ldt.contiguous())
        y_dot = F.add(T[:, p.idot, : p.dblock].contiguous(),
                      s_dot.contiguous())
        y_quad = F.add(T[:, p.iquad, : p.dblock].contiguous(),
                       s_quad.contiguous())
        return y_ldt, y_dot, y_quad

    def assemble(self, lane: int, y_ldt, y_dot, y_quad, idx,
                 cols) -> LigeroProof:
        """Lane `lane`'s LigeroProof from its fetched responses and
        openings (host arrays of the device finish,
        zk/fused.ligero_finish_dev: y_ldt [block, N], y_dot and y_quad
        [dblock, N], idx [nreq], cols [nrow, nreq, N]), with the Merkle
        openings of the chosen columns."""
        p, F = self.p, self.F
        proof = LigeroProof()
        proof.y_ldt = list(F.from_limbs(torch.from_numpy(y_ldt)))
        proof.y_dot = list(F.from_limbs(torch.from_numpy(y_dot)))
        yq = F.from_limbs(torch.from_numpy(y_quad))
        proof.y_quad_0 = list(yq[: p.r])
        proof.y_quad_2 = list(yq[p.block : p.dblock])
        colv = F.from_limbs(torch.from_numpy(cols))  # [nrow, nreq] ints
        proof.req = [list(colv[i]) for i in range(p.nrow)]
        proof.merkle_path, proof.merkle_nonce = self.mcs[lane].open(
            [int(i) for i in idx])
        return proof
