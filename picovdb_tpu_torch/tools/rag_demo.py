"""Text-RAG demo on picovdb_tpu_torch: chunk -> embed -> index -> query
(+ self-retrieval check).

Counterpart of picovdb_tpu's bench/rag_demo.py, with the same flags except
`--device cpu|cuda` (default: the card) in place of `--platform`. Embeds
with the dependency-free HashingEmbedder by default, the byte-level
ByteMeanPoolEncoder on the device with --embedder byte (the JAX demo's
`flax`), a converted HF BERT checkpoint (MiniLM etc.) on the device with
--embedder bert --model-path DIR, the checkpoint-free random-weight BERT
with --embedder bert-random, or sentence-transformers with --embedder st
when installed. The self-retrieval pass mirrors the reference's
recall-style mismatch counting (bench/hf_query.py:38-52).

--device-pipeline keeps every vector on the device: the encoder's batches
are concatenated there, `ingest_device` adopts the matrix, and the query
embeddings go device to device into `query_columnar`. No corpus or query
vector is copied to the host on that path, so the store is not saved
there (saving writes the vectors to disk).

Usage:
  python -m picovdb_tpu_torch.tools.rag_demo [--text book.txt] [--chunk 256]
      [--embedder hashing|byte|bert|bert-random|st] [--model-path DIR]
      [--device cpu|cuda] [--device-pipeline] [--query "..."]
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from picovdb_tpu_torch import K_ID, K_METRICS, K_VECTOR, PicoVectorDB
from picovdb_tpu_torch.models.bert_encoder import resolve_device

SAMPLE = """
The archive keeps every observation the station has ever made: pressure
readings from the pass, snow depth at the tree line, the slow migration of
the glacier's terminus year over year. Researchers query it by similarity,
not by key. A question about avalanche conditions in late spring pulls up
field notes from three different decades. The index does not care when a
note was written; it cares what the note is about.

Down in the valley the weather is a different animal entirely. Rain shadows
carve dry channels through otherwise soaked terrain, and the vineyard crews
read humidity off the morning fog instead of any instrument. Their notes
talk about budbreak, frost fans, and the smell of the soil after the first
warm week. When the archive answers a valley question with a mountain note,
someone files a correction, and the embeddings drift a little closer to the
truth.

Shipping manifests are the archive's third voice. Crates of instruments
come up the switchback road twice a season: anemometers, radiosondes, spare
solar panels, and once, famously, a crate of lemons mislabeled as optical
filters. The manifest notes are terse and full of part numbers, nothing
like the field journals, and the index learned quickly to keep them apart.

The station cook keeps a log too. Bread rises slower at altitude; stews
want an extra hour; the espresso machine needs a different grind when the
front comes through. Nobody planned for the cook's log to enter the
archive, but the researchers kept asking it questions — what did we eat
during the storm of September? — and the answers kept being useful.
"""

STORE = "rag_demo_db"


def chunk_text(text: str, size: int):
    text = " ".join(text.split())
    return [text[i : i + size] for i in range(0, len(text), size) if text[i : i + size].strip()]


def make_embedder(args, chunks):
    """The embedder `--embedder` names; sets `args.dim` to its width."""
    if args.embedder == "hashing":
        from picovdb_tpu_torch.models import HashingEmbedder

        return HashingEmbedder(dim=args.dim)
    if args.embedder == "byte":
        from picovdb_tpu_torch.models import ByteMeanPoolEncoder

        return ByteMeanPoolEncoder(dim=args.dim, device=args.device)
    if args.embedder == "st":
        from picovdb_tpu_torch.models import TorchSentenceEmbedder

        emb = TorchSentenceEmbedder()
        args.dim = emb.dim
        return emb
    from picovdb_tpu_torch.models import BertMeanPoolEncoder

    if args.embedder == "bert":
        if not args.model_path:
            raise SystemExit(
                "--embedder bert needs --model-path <local HF checkpoint "
                "dir> (no checkpoint is downloaded; any BertModel-"
                "architecture sentence embedder works)"
            )
        emb = BertMeanPoolEncoder.from_pretrained(args.model_path,
                                                  device=args.device)
    else:
        # Checkpoint-free BERT: deterministic random weights (the same as
        # picovdb_tpu's random_init) + corpus-built word vocab. Embeddings
        # are reproducible and discriminative enough for self-retrieval
        # (each chunk must rank itself first), which is what the
        # reference's mismatch counter measures (bench/hf_query.py:38-52);
        # semantic quality needs real weights (--embedder bert).
        emb = BertMeanPoolEncoder.random_init(corpus_texts=chunks,
                                              device=args.device)
    args.dim = emb.dim
    return emb


def main(argv=None) -> dict:
    """Run the demo; returns {"top": the query's top ids, "mismatches":
    self-retrieval misses, "chunks": corpus size}."""
    p = argparse.ArgumentParser()
    p.add_argument("--text", help="path to a .txt corpus (default: built-in sample)")
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--embedder",
                   choices=["hashing", "byte", "bert", "bert-random", "st"],
                   default="hashing")
    p.add_argument("--device-pipeline", action="store_true",
                   help="keep embeddings on the device end to end: encoder "
                        "output feeds ingest_device (corpus) and "
                        "query_columnar (queries) with no vector host "
                        "traffic")
    p.add_argument("--batch", type=int, default=64,
                   help="encoder batch size (chunks per forward pass)")
    p.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                   help="where the store and the encoder live")
    p.add_argument("--model-path",
                   help="local HF checkpoint dir for --embedder bert (e.g. a "
                        "downloaded copy of sentence-transformers/"
                        "all-MiniLM-L6-v2)")
    p.add_argument("--dim", type=int, default=384)
    p.add_argument("--query", default="what does the index do with questions")
    p.add_argument("--topk", type=int, default=3)
    args = p.parse_args(argv)

    args.device = resolve_device(args.device)  # "cuda" -> the current card
    text = open(args.text, encoding="utf-8").read() if args.text else SAMPLE
    chunks = chunk_text(text, args.chunk)
    print(f"{len(chunks)} chunks of ~{args.chunk} chars")
    emb = make_embedder(args, chunks)

    metadata = [{"text": c} for c in chunks]
    ids = [f"chunk{i}" for i in range(len(chunks))]
    for suffix in (".ids.json", ".meta.json", ".vecs.npy"):
        if os.path.exists(STORE + suffix):
            os.remove(STORE + suffix)  # a fresh store every run
    db = PicoVectorDB(embedding_dim=args.dim, storage_file=STORE,
                      device=args.device)

    if args.device_pipeline:
        if not hasattr(emb, "embed_device"):
            raise SystemExit(
                f"--device-pipeline needs an on-device embedder; "
                f"{args.embedder!r} embeds on host"
            )
        t0 = time.perf_counter()
        parts = [
            emb.embed_device(chunks[s : s + args.batch])
            for s in range(0, len(chunks), args.batch)
        ]
        vecs_dev = parts[0] if len(parts) == 1 else torch.cat(parts)
        if vecs_dev.is_cuda:
            torch.cuda.synchronize(vecs_dev.device)
        t_embed = time.perf_counter() - t0
        print(f"embedding (on-device): {t_embed:.2f} s "
              f"({len(chunks)/t_embed:.0f} chunks/s)")
        db.ingest_device(vecs_dev, ids=ids, metadata=metadata)
        top_ids, top_scores = db.query_columnar(
            emb.embed_device([args.query]), top_k=args.topk)
        hits = [{K_ID: i, K_METRICS: float(s), **db.get(i)}
                for i, s in zip(top_ids[0], top_scores[0]) if i is not None]
    else:
        t0 = time.perf_counter()
        vecs = emb.embed(chunks)
        print(f"embedding: {time.perf_counter() - t0:.2f} s")
        db.upsert(
            [
                {K_ID: ids[i], K_VECTOR: vecs[i], "text": chunks[i]}
                for i in range(len(chunks))
            ]
        )
        db.save()
        hits = db.query(emb.embed([args.query])[0], top_k=args.topk)
    print(f"\nquery: {args.query!r}")
    for r in hits:
        print(f"  {r[K_METRICS]:.3f} {r[K_ID]}: {r['text'][:90]}…")

    # self-retrieval: each chunk's own embedding must rank itself first
    # (the reference's mismatch counter, bench/hf_query.py:38-52)
    t0 = time.perf_counter()
    if args.device_pipeline:
        sids, _scores = db.query_columnar(vecs_dev, top_k=1)
        hits_ids = [s[0] if len(s) else None for s in sids]
    else:
        results = db.query_batched(vecs, top_k=1)
        hits_ids = [h[0][K_ID] if h else None for h in results]
    mismatches = sum(
        1 for i, hid in enumerate(hits_ids) if hid != f"chunk{i}"
    )
    print(f"\nself-retrieval mismatches: {mismatches}/{len(chunks)} "
          f"({time.perf_counter()-t0:.2f} s)")
    return {"top": [r[K_ID] for r in hits], "mismatches": mismatches,
            "chunks": len(chunks)}


if __name__ == "__main__":
    main()
