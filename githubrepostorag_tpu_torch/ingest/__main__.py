"""Ingest CLI: ``python -m githubrepostorag_tpu_torch.ingest [--local PATH]
[--repo NAME ...]`` (the K8s Job entrypoint, ingest/src/app/__main__.py in
the reference); port of ``githubrepostorag_tpu/ingest/__main__.py``.  With
--local, reads a directory instead of GitHub.  Every mode respects the
.skip_ingest / .ingest_complete sentinels under DATA_DIR unless --force.

    python -m githubrepostorag_tpu_torch.ingest --local DIR                # on the card
    python -m githubrepostorag_tpu_torch.ingest --local DIR --device cpu   # plain path

The store's device index (``DEVICE_INDEX``) and the BERT encoder
(``EMBED_MODEL``) go on the card unless ``--device cpu`` asks for the CPU.
The LLM is the process-wide one (``llm.get_shared_llm``): ``LLM_BACKEND=http``
against the model server (``python -m githubrepostorag_tpu_torch.serving``)
or ``fake``; ``inprocess`` needs an ``InProcessLLM`` set with
``llm.set_llm`` first, as in the JAX package."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Ingest repositories into the vector index")
    parser.add_argument("--repo", action="append", default=None, help="repo name (repeatable)")
    parser.add_argument("--local", default=None, help="ingest a local directory instead of GitHub")
    parser.add_argument("--namespace", default=None)
    parser.add_argument("--branch", default=None)
    parser.add_argument("--force", action="store_true", help="ignore resume sentinels")
    parser.add_argument("--watch", action="store_true",
                        help="with --local: keep polling the directory and "
                             "re-ingest on change (streams through the live "
                             "index when LIVE_INDEX=on)")
    parser.add_argument("--watch-interval", type=float, default=2.0,
                        help="seconds between --watch polls")
    parser.add_argument("--watch-polls", type=int, default=None,
                        help="stop --watch after N polls (default: forever)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu, for the store's device index "
                             "and the encoder")
    args = parser.parse_args(argv)

    s = get_settings()
    namespace = args.namespace or s.default_namespace

    if s.data_dir and not args.force:
        root = Path(s.data_dir)
        for sentinel in (".skip_ingest", ".ingest_complete"):
            if (root / sentinel).exists():
                logger.info("%s present; skipping ingest (use --force to override)", sentinel)
                return 0
    if args.watch and not args.local:
        parser.error("--watch requires --local")

    from githubrepostorag_tpu_torch.embedding import get_encoder
    from githubrepostorag_tpu_torch.ingest.controller import ingest_component, ingest_many
    from githubrepostorag_tpu_torch.store import get_store

    # the process-wide store and encoder, built on --device before any stage
    get_store(args.device)
    get_encoder(args.device)

    if args.watch:
        from githubrepostorag_tpu_torch.ingest.sources import LocalRepoReader
        from githubrepostorag_tpu_torch.ingest.stream import watch_local

        name = (args.repo or [Path(args.local).resolve().name])[0]

        def reingest() -> None:
            docs = LocalRepoReader(args.local).load()
            record = ingest_component(name, namespace=namespace, docs=docs,
                                      branch=args.branch)
            logger.info("watch: re-ingested %s (%s nodes)", name,
                        record.get("nodes", "?"))

        fired = watch_local(args.local, reingest,
                            interval_s=args.watch_interval,
                            max_polls=args.watch_polls)
        print(json.dumps({"watch": args.local, "ingests": fired}))
        if s.store_backend in ("memory", "native") and s.store_path:
            get_store().save()
        return 0

    if args.local:
        from githubrepostorag_tpu_torch.ingest.sources import LocalRepoReader

        name = (args.repo or [Path(args.local).resolve().name])[0]
        docs = LocalRepoReader(args.local).load()
        record = ingest_component(name, namespace=namespace, docs=docs, branch=args.branch)
        print(json.dumps(record, indent=2))
        if s.store_backend in ("memory", "native") and s.store_path:
            get_store().save()  # persist the local index
        if s.data_dir:
            (Path(s.data_dir) / ".ingest_complete").write_text(
                json.dumps({"finished_at": record["finished_at"], "repos": 1})
            )
        return 0

    results = ingest_many(components=args.repo, namespace=namespace, branch=args.branch)
    print(json.dumps(results, indent=2))
    if s.store_backend in ("memory", "native") and s.store_path:
        get_store().save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
