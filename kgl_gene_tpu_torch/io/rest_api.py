"""Synchronous HTTP facade.

Capability parity with RestAPI (kel_io/kel_rest_api.h:24, libcurl facade):
GET/POST with query parameters and timeouts over urllib — no external
dependency. Network use is caller-gated (air-gapped runs pass
allow_network=False and receive None).

Copy of kgl_gene_tpu/io/rest_api.py.
"""

from __future__ import annotations

import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Optional

from ..utils.logging import log

__all__ = ["RestAPI"]


class RestAPI:
    def __init__(self, base_url: str = "", timeout_s: float = 30.0,
                 allow_network: bool = True):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.allow_network = allow_network

    def _url(self, path: str, params: Optional[Dict[str, str]]) -> str:
        url = f"{self.base_url}/{path.lstrip('/')}" if self.base_url else path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        return url

    def synchronous_request(self, path: str,
                            params: Optional[Dict[str, str]] = None) -> Optional[str]:
        """GET; returns the body text or None on failure."""
        if not self.allow_network:
            return None
        try:
            with urllib.request.urlopen(
                self._url(path, params), timeout=self.timeout_s
            ) as resp:
                return resp.read().decode()
        except (urllib.error.URLError, OSError) as exc:
            log().warn("REST GET {} failed: {}", path, exc)
            return None

    def post_request(self, path: str, data: bytes,
                     params: Optional[Dict[str, str]] = None,
                     content_type: str = "application/x-www-form-urlencoded") -> Optional[str]:
        if not self.allow_network:
            return None
        request = urllib.request.Request(
            self._url(path, params), data=data,
            headers={"Content-Type": content_type}, method="POST",
        )
        try:
            with urllib.request.urlopen(request, timeout=self.timeout_s) as resp:
                return resp.read().decode()
        except (urllib.error.URLError, OSError) as exc:
            log().warn("REST POST {} failed: {}", path, exc)
            return None
