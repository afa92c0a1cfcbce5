"""Ingest orchestrator: per-repo pipeline + multi-repo driver; a copy of
``githubrepostorag_tpu/ingest/controller.py`` whose Pushgateway push is the
standard library's (the same PUT of the text format that
``prometheus_client.push_to_gateway`` sends; the port's runtime does not
need ``prometheus_client``).

Rebuild of ingest_controller.py:192-542 with its quirks fixed: the audit
record actually writes (the reference's CQL INSERT used ?-placeholders on an
unprepared statement and always failed silently, :419-435), and the
``.ingest_complete`` sentinel is actually written (the K8s resume check read
a file nothing produced — ingest-job.yaml:35-53).

Stages (each timed; gauges pushed when PUSHGATEWAY_URL is set):
  preprocess -> code_nodes (chunk + batched extractors) -> catalog ->
  file_summaries -> module_summaries -> repo_summary -> vector_write ->
  audit
"""

from __future__ import annotations

import base64
import json
import time
import urllib.request
import uuid
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable
from urllib.parse import quote_plus, urlsplit

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.embedding import TextEncoder
from githubrepostorag_tpu_torch.ingest import catalog as catalog_mod
from githubrepostorag_tpu_torch.ingest import hierarchy
from githubrepostorag_tpu_torch.ingest.chunker import split_document
from githubrepostorag_tpu_torch.ingest.extractors import enrich_nodes
from githubrepostorag_tpu_torch.ingest.preprocess import prepare_repo_documents
from githubrepostorag_tpu_torch.ingest.types import Node, SourceDoc
from githubrepostorag_tpu_torch.ingest.vector_write import write_nodes_per_scope
from githubrepostorag_tpu_torch.llm import LLM, get_shared_llm
from githubrepostorag_tpu_torch.store import VectorStore
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

StageCallback = Callable[[str, float], None]


# the gauge one push carries, and the exposition format it is written in
_GAUGE = "ingest_stage_duration_seconds"
_GAUGE_HELP = "Wall-clock of one ingest stage"
PUSH_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _grouping_part(key: str, value: str) -> tuple[str, str]:
    """One label of a Pushgateway URL path, escaped as ``prometheus_client``
    escapes it: base64 for an empty value or one with a slash or a space."""
    if value == "":
        return key + "@base64", "="
    if "/" in value or " " in value:
        return key + "@base64", base64.urlsafe_b64encode(value.encode("utf-8")).decode("utf-8")
    return key, quote_plus(value)


def _go_float(value: float) -> str:
    """A sample value as the text format writes it (Go's exponent rule)."""
    text = repr(float(value))
    dot = text.find(".")
    if value > 0 and dot > 6:
        return f"{text[0]}.{text[1:dot]}{text[dot + 1:]}".rstrip("0.") + f"e+0{dot - 1}"
    return text


def _push_url(gateway: str, grouping: dict[str, str]) -> str:
    if urlsplit(gateway).scheme not in ("http", "https"):
        gateway = f"http://{gateway}"
    url = "{}/metrics/{}/{}".format(gateway.rstrip("/"), *_grouping_part("job", "ingest"))
    return url + "".join("/{}/{}".format(*_grouping_part(str(k), str(v)))
                         for k, v in sorted(grouping.items()))


def _push_stage_gauge(stage: str, seconds: float, grouping: dict[str, str]) -> None:
    """One-off gauge per stage to the Pushgateway (ingest_controller.py:82-152):
    a PUT of ``ingest_stage_duration_seconds{stage=...}`` to
    ``/metrics/job/ingest/<grouping>``, as ``push_to_gateway`` sends it."""
    url = get_settings().pushgateway_url
    if not url:
        return
    try:
        label = stage.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')
        body = (f"# HELP {_GAUGE} {_GAUGE_HELP}\n# TYPE {_GAUGE} gauge\n"
                f'{_GAUGE}{{stage="{label}"}} {_go_float(seconds)}\n').encode("utf-8")
        req = urllib.request.Request(_push_url(url, grouping), data=body, method="PUT",
                                     headers={"Content-Type": PUSH_CONTENT_TYPE})
        with urllib.request.urlopen(req, timeout=30) as resp:
            resp.read()
    except Exception as exc:  # noqa: BLE001 - metrics must not break ingest
        logger.warning("pushgateway push failed for stage %s: %s", stage, exc)


@contextmanager
def stage_timer(stage: str, grouping: dict[str, str], timings: dict[str, float],
                on_stage: StageCallback | None = None):
    from githubrepostorag_tpu_torch.utils.profiling import annotate

    start = time.monotonic()
    logger.info("stage %s: start", stage)
    try:
        with annotate(f"ingest.{stage}"):
            yield
    finally:
        elapsed = time.monotonic() - start
        timings[stage] = round(elapsed, 3)
        logger.info("stage %s: %.2fs", stage, elapsed)
        _push_stage_gauge(stage, elapsed, grouping)
        if on_stage:
            try:
                on_stage(stage, elapsed)
            except Exception:  # noqa: BLE001
                logger.exception("stage callback failed")


def _dump_raw_docs(docs: list[SourceDoc], repo: str, branch: str) -> None:
    """Raw-document JSON dump for resumability (ingest_controller.py:154-161)."""
    data_dir = get_settings().data_dir
    if not data_dir:
        return
    out = Path(data_dir) / "repos" / repo
    out.mkdir(parents=True, exist_ok=True)
    payload = [{"path": d.path, "text": d.text, "metadata": d.metadata} for d in docs]
    (out / f"raw_documents_{branch}.json").write_text(json.dumps(payload))


def _append_audit(record: dict[str, Any]) -> None:
    """Run manifest (the reference's broken ingest_runs INSERT, fixed as an
    append-only JSONL manifest under DATA_DIR)."""
    data_dir = get_settings().data_dir
    if not data_dir:
        return
    path = Path(data_dir) / "ingest_runs.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("a") as fh:
        fh.write(json.dumps(record) + "\n")


def ingest_component(
    repo: str,
    namespace: str = "default",
    docs: list[SourceDoc] | None = None,
    branch: str | None = None,
    llm: LLM | None = None,
    store: VectorStore | None = None,
    encoder: TextEncoder | None = None,
    on_stage: StageCallback | None = None,
    dev_force_standalone: bool | None = None,
) -> dict[str, Any]:
    """Run the full per-repo pipeline.  ``docs`` may be pre-loaded (local
    reader / tests); otherwise the GitHub service fetches them."""
    s = get_settings()
    llm = llm or get_shared_llm()
    branch = branch or s.default_branch
    run_id = uuid.uuid4().hex
    grouping = {"run_id": run_id, "repo": repo, "namespace": namespace, "branch": branch}
    timings: dict[str, float] = {}
    t_start = time.monotonic()

    common = {
        "namespace": namespace,
        "repo": repo,
        "collection": s.default_collection,
    }

    if docs is None:
        from githubrepostorag_tpu_torch.ingest.sources import GithubService

        docs = GithubService().load_repo_documents(repo, branch)
    _dump_raw_docs(docs, repo, branch)

    with stage_timer("preprocess", grouping, timings, on_stage):
        force_standalone = (
            s.dev_force_standalone if dev_force_standalone is None else dev_force_standalone
        )
        prepared = prepare_repo_documents(docs, force_standalone)
        if prepared:
            common["component_kind"] = prepared[0].metadata.get("component_kind", "service")

    with stage_timer("code_nodes", grouping, timings, on_stage):
        chunk_nodes: list[Node] = []
        for doc in prepared:
            language = doc.metadata.get("language")
            for chunk in split_document(doc.text, language):
                md = dict(common)
                md.update(
                    scope="chunk",
                    file_path=doc.path,
                    module=hierarchy.top_directory(doc.path),
                    language=language or "",
                    span=chunk.span,
                )
                chunk_nodes.append(Node(text=chunk.text, metadata=md))
        enrich_nodes(llm, chunk_nodes)

    with stage_timer("catalog", grouping, timings, on_stage):
        catalog_node = catalog_mod.build_catalog_node(llm, prepared, chunk_nodes, common)

    with stage_timer("file_summaries", grouping, timings, on_stage):
        file_nodes = hierarchy.build_file_nodes(llm, chunk_nodes, common)

    with stage_timer("module_summaries", grouping, timings, on_stage):
        module_nodes = hierarchy.build_module_nodes(llm, file_nodes, common)

    with stage_timer("repo_summary", grouping, timings, on_stage):
        readmes = [(d.path, d.text) for d in prepared
                   if d.path.lower().rsplit("/", 1)[-1].startswith("readme")]
        repo_node = hierarchy.build_repo_node(llm, module_nodes, readmes, common)

    with stage_timer("vector_write", grouping, timings, on_stage):
        written = write_nodes_per_scope(
            {
                "catalog": [catalog_node],
                "repo": [repo_node],
                "module": module_nodes,
                "file": file_nodes,
                "chunk": chunk_nodes,
            },
            store=store,
            encoder=encoder,
        )

    total = round(time.monotonic() - t_start, 3)
    record = {
        "run_id": run_id,
        "repo": repo,
        "namespace": namespace,
        "branch": branch,
        "source_docs": len(docs),
        "prepared_docs": len(prepared),
        "written": written,
        "timings": timings,
        "total_seconds": total,
        "finished_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    with stage_timer("audit_and_clean", grouping, timings, on_stage):
        _append_audit(record)
    _push_stage_gauge("total", total, grouping)
    return record


def ingest_many(
    components: list[str] | None = None,
    namespace: str = "default",
    branch: str | None = None,
    llm: LLM | None = None,
    store: VectorStore | None = None,
    encoder: TextEncoder | None = None,
    on_stage: StageCallback | None = None,
) -> list[dict[str, Any]]:
    """Multi-repo driver (ingest_controller.py:490-542): explicit component
    list, or GraphQL discovery of the configured user's repos."""
    s = get_settings()
    repo_specs: list[dict]
    if components:
        repo_specs = [{"name": c, "default_branch": branch or s.default_branch} for c in components]
    else:
        from githubrepostorag_tpu_torch.ingest.sources import GithubService

        repo_specs = GithubService().fetch_repositories()

    results = []
    for spec in repo_specs:
        try:
            results.append(
                ingest_component(
                    spec["name"], namespace=namespace,
                    branch=branch or spec.get("default_branch"),
                    llm=llm, store=store, encoder=encoder, on_stage=on_stage,
                )
            )
        except Exception as exc:  # noqa: BLE001 - one bad repo must not kill the job
            logger.exception("ingest failed for %s", spec["name"])
            results.append({"repo": spec["name"], "error": str(exc)})

    # write the completion sentinel the K8s Job's resume check looks for
    # (the reference checked it but never wrote it — SURVEY.md Appendix A)
    data_dir = s.data_dir
    if data_dir:
        try:
            (Path(data_dir) / ".ingest_complete").write_text(
                json.dumps({"finished_at": time.time(), "repos": len(results)})
            )
        except OSError as exc:
            logger.warning("could not write .ingest_complete: %s", exc)
    return results
