"""Block data-parallelism: shard the block batch over a 1-D device mesh.

The reference encodes blocks sequentially in one thread (lib/lib.rs:101-126);
blocks are fully independent apart from the ordered stream-CRC fold, so the
natural scaling axis is a 1-D ``('blocks',)`` mesh with the per-block
pipeline shard_mapped across it.  Compressed payloads come back as
fixed-size (words, bit-length) pairs; the host stitches them in input order
and folds the stream CRC (the only order-dependent state).

No cross-device collectives are needed on the hot path — inter-device
traffic is zero during encode; only the host gather at the end moves data.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.bitpack import block_payload_entries, pack_entries
from ..ops.bwt import bwt_rotations
from ..ops.huffman import plan_entropy_device
from ..ops.mtf import mtf_indices_device
from ..ops.rle2 import rle2_device

import jax.numpy as jnp


def block_mesh(devices=None) -> Mesh:
    """1-D mesh over the host's local (or the given) devices.

    Local, not global: in a multi-process job each host encodes its own
    input span independently (parallel/multihost.py); cross-host traffic
    happens only at the final payload gather, never inside the mesh.
    """
    if devices is None:
        devices = jax.local_devices()
    return Mesh(np.asarray(devices), ("blocks",))


def encode_one_block(
    block, n, pres, *, nseg: int, nwords: int, chunk: int = 512,
):
    """The complete per-block device pipeline (shared by DP and single-chip).

    Stages are wrapped in jax.named_scope so profiler traces group device
    ops by pipeline stage (SURVEY.md §5 tracing row).
    """
    num_names = jnp.sum(pres.astype(jnp.int32))
    with jax.named_scope("bwt"):
        bwt, ptr = bwt_rotations(block, n)
    with jax.named_scope("mtf"):
        idx = mtf_indices_device(bwt, n, pres, chunk=chunk)
    with jax.named_scope("rle2"):
        syms, out_len, _ = rle2_device(idx, n, num_names, with_freqs=False)
    num_syms = num_names + 2
    with jax.named_scope("huffman_plan"):
        plan = plan_entropy_device(syms, out_len, num_syms, nseg)
    with jax.named_scope("bitpack"):
        vals, lens = block_payload_entries(
            syms,
            out_len,
            num_syms,
            plan["num_tables"],
            plan["tables"],
            plan["selectors"],
            plan["sel_mtf_idx"],
            plan["nseg_used"],
        )
        words, total_bits = pack_entries(vals, lens, nwords)
    # plan_bits / banzai split / mtf length ride the fetch so the host
    # drain thread can run the <=-banzai contract check off-device
    # (huffman_host.banzai_wins; see ops/huffman.plan_entropy_device).
    return (
        words, total_bits, ptr, plan["total_bits"], plan["banzai_split"],
        out_len,
    )


def encode_batch_rows(rows, *, nseg: int, nwords: int, chunk: int):
    """Unpack a packed [B, N+260] row batch and encode every block — the
    ONE batch body shared by the single-chip jit (pipeline._encode_blocks)
    and the shard_map below (they must stay in lockstep: same row layout,
    same per-block signature)."""
    from ..pipeline import _ROW_EXTRA, _unpack_rows

    blocks, ns, present = _unpack_rows(rows, rows.shape[1] - _ROW_EXTRA)
    fn = jax.vmap(
        partial(encode_one_block, nseg=nseg, nwords=nwords, chunk=chunk)
    )
    return fn(blocks, ns, present)


@partial(jax.jit, static_argnames=("nseg", "nwords", "mesh", "chunk"))
def encode_blocks_sharded(
    packed, *, nseg: int, nwords: int, mesh: Mesh, chunk: int = 512,
):
    """Encode a packed [B, N+260] block batch sharded over ``mesh``
    (B % ndev == 0; row layout per pipeline._unpack_rows — the single
    upload also means each device receives only its own block rows)."""
    shard_fn = partial(
        encode_batch_rows, nseg=nseg, nwords=nwords, chunk=chunk,
    )

    sharded = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("blocks", None),),
        out_specs=(
            P("blocks", None), P("blocks"), P("blocks"),
            P("blocks"), P("blocks", None, None), P("blocks"),
        ),
        # The per-block pipeline is embarrassingly parallel; loop carries
        # initialized from constants trip the varying-axes checker.
        check_vma=False,
    )
    return sharded(packed)
