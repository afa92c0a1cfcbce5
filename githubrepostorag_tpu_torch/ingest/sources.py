"""Repository document sources: GitHub (REST + GraphQL) and local paths; a
copy of ``githubrepostorag_tpu/ingest/sources.py`` whose GitHub client runs
on the standard library's ``urllib`` (the JAX package's uses ``requests``,
which the port's runtime does not need).

Rebuild of github_service.py: repo discovery via the GraphQL API (paged
100, skipping forks/archived/private, :28-79) and content loading — here
via the git tarball endpoint in one request instead of the reference's
6-way-concurrent per-file REST reader (github_service.py:16-25), which is
both faster and rate-limit-friendlier.  A local-directory reader serves
tests, dev, and the self-ingest slice (SURVEY.md §7 step 4).  Redirects
(the tarball endpoint answers 302 to its download host) are followed as
``requests`` follows them: the token goes only to the host it was given
for.
"""

from __future__ import annotations

import io
import json
import os
import tarfile
import urllib.request
from pathlib import Path
from urllib.parse import urlsplit

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.ingest.types import SourceDoc
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_GITHUB_API = "https://api.github.com"
_SKIP_DIRS = {".git", "node_modules", "__pycache__", ".venv", "venv", ".tox",
              "dist", "build", ".idea", ".vscode", "target", ".mypy_cache",
              ".pytest_cache", ".eggs"}
MAX_FILE_BYTES = 2_000_000


class LocalRepoReader:
    """Read every text file under a directory (the dev/self-ingest path)."""

    def __init__(self, root: str) -> None:
        self.root = Path(root)

    def load(self, repo_name: str | None = None) -> list[SourceDoc]:
        if not self.root.is_dir():
            raise FileNotFoundError(f"local repo path {self.root} is not a directory")
        docs: list[SourceDoc] = []
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for fname in sorted(filenames):
                full = Path(dirpath) / fname
                rel = str(full.relative_to(self.root))
                try:
                    if full.stat().st_size > MAX_FILE_BYTES:
                        continue
                    text = full.read_text(encoding="utf-8")
                except (UnicodeDecodeError, OSError):
                    continue
                docs.append(SourceDoc(path=rel, text=text))
        return docs


class _TokenStaysOnHost(urllib.request.HTTPRedirectHandler):
    """Follow redirects, dropping the Authorization header when one leaves
    the host it was sent to (as ``requests`` does)."""

    def redirect_request(self, req, fp, code, msg, headers, newurl):
        new = super().redirect_request(req, fp, code, msg, headers, newurl)
        if new is not None and urlsplit(newurl).hostname != urlsplit(req.full_url).hostname:
            new.remove_header("Authorization")
        return new


_opener = urllib.request.build_opener(_TokenStaysOnHost)


class GithubService:
    """GitHub API access; requires network + token (gated — local/dev uses
    LocalRepoReader)."""

    def __init__(self, token: str | None = None, user: str | None = None) -> None:
        s = get_settings()
        self.token = token or s.github_token
        self.user = user or s.github_user

    def _headers(self) -> dict:
        h = {"Accept": "application/vnd.github+json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    def _fetch(self, url: str, timeout: float, payload: dict | None = None) -> bytes:
        """GET ``url`` (POST ``payload`` as JSON when given); any status
        other than 2xx raises ``urllib.error.HTTPError``."""
        headers = self._headers()
        data = None
        if payload is not None:
            data = json.dumps(payload).encode("utf-8")
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method="POST" if data is not None else "GET")
        with _opener.open(req, timeout=timeout) as resp:
            return resp.read()

    def fetch_repositories(self) -> list[dict]:
        """All public, non-fork, non-archived repos of the user via GraphQL
        (paged 100 — github_service.py:28-79)."""
        repos: list[dict] = []
        cursor = None
        query = """
        query($login: String!, $cursor: String) {
          user(login: $login) {
            repositories(first: 100, after: $cursor, privacy: PUBLIC,
                         ownerAffiliations: OWNER) {
              pageInfo { hasNextPage endCursor }
              nodes { name isFork isArchived isPrivate defaultBranchRef { name } }
            }
          }
        }"""
        while True:
            raw = self._fetch(
                f"{_GITHUB_API}/graphql", 60,
                {"query": query, "variables": {"login": self.user, "cursor": cursor}},
            )
            data = json.loads(raw)["data"]["user"]["repositories"]
            for node in data["nodes"]:
                if node["isFork"] or node["isArchived"] or node["isPrivate"]:
                    continue
                branch = (node.get("defaultBranchRef") or {}).get("name") or "main"
                repos.append({"name": node["name"], "default_branch": branch})
            if not data["pageInfo"]["hasNextPage"]:
                break
            cursor = data["pageInfo"]["endCursor"]
        return repos

    def load_repo_documents(self, repo: str, branch: str | None = None) -> list[SourceDoc]:
        """One tarball request for the whole tree."""
        branch = branch or get_settings().default_branch
        url = f"{_GITHUB_API}/repos/{self.user}/{repo}/tarball/{branch}"
        content = self._fetch(url, 120)

        docs: list[SourceDoc] = []
        with tarfile.open(fileobj=io.BytesIO(content), mode="r:gz") as tar:
            for member in tar.getmembers():
                if not member.isfile() or member.size > MAX_FILE_BYTES:
                    continue
                rel = member.name.split("/", 1)[-1]  # strip the org-repo-sha/ prefix
                if any(part in _SKIP_DIRS for part in rel.split("/")):
                    continue
                fh = tar.extractfile(member)
                if fh is None:
                    continue
                try:
                    text = fh.read().decode("utf-8")
                except UnicodeDecodeError:
                    continue
                docs.append(SourceDoc(path=rel, text=text))
        return docs
