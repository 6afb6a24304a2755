"""PubMed efetch/elink client with a disk cache.

Capability parity with PubmedAPIRequester / PubmedAPICache /
ParsePublicationXMLMessage (kgl_parser/kgl_pubmed_api.h:31,59,63,
kgl_pubmed_cache.h, kgl_pubmed_xml_parser.h, resource kgl_pubmed_resource.h):
batched NCBI requests (<=10 pmids per efetch batch, <=100 per elink batch,
>= 1 s between batches, api-key support), XML reply parsing, and a
write-through disk cache of publication/citation XML so later runs are
offline. Network access is gated: in a zero-egress environment every
lookup is served from the cache only.

Copy of kgl_gene_tpu/literature/pubmed.py, with two changes: the replies
are parsed by the standard library's xml.etree.ElementTree instead of
lxml (the same finds, itertext and attributes; ET.ParseError for lxml's
XMLSyntaxError), so the port needs no lxml; and the cache reader strips
each record before parsing it. The reference parses a record with the
newline _append_cache writes after the marker before it, so an XML
declaration (every NCBI reply starts with one) is off the start of any
record but the first, which then fails to parse: its cache serves only
its first reply.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, List, Optional, Set

import xml.etree.ElementTree as ET

from ..utils.logging import log
from .publication import PublicationSummary

__all__ = ["PubmedRequester", "parse_pubmed_article_xml", "parse_elink_citation_xml"]

EFETCH_BATCH = 10
ELINK_BATCH = 100
BATCH_DELAY_S = 1.0
PUBLICATION_CACHE = "pubmed_publication_cache.xml"
CITATION_CACHE = "pubmed_citation_cache.xml"


# --------------------------------------------------------------------------- #
# XML parsing (rapidxml -> xml.etree)
# --------------------------------------------------------------------------- #
def parse_pubmed_article_xml(xml_text: str) -> Dict[str, PublicationSummary]:
    """Parse an efetch PubmedArticleSet reply."""
    out: Dict[str, PublicationSummary] = {}
    try:
        root = ET.fromstring(xml_text.encode())
    except ET.ParseError as exc:
        log().warn("pubmed XML parse error: {}", exc)
        return out
    for article in root.iter("PubmedArticle"):
        pmid_node = article.find(".//PMID")
        if pmid_node is None or not pmid_node.text:
            continue
        pub = PublicationSummary(pmid=pmid_node.text.strip())
        title = article.find(".//ArticleTitle")
        pub.title = "".join(title.itertext()).strip() if title is not None else ""
        abstract = article.find(".//Abstract")
        if abstract is not None:
            pub.abstract = " ".join(
                "".join(t.itertext()).strip() for t in abstract.findall("AbstractText")
            )
        journal = article.find(".//Journal/Title")
        pub.journal = journal.text.strip() if journal is not None and journal.text else ""
        volume = article.find(".//JournalIssue/Volume")
        pub.journal_volume = volume.text.strip() if volume is not None and volume.text else ""
        issue = article.find(".//JournalIssue/Issue")
        pub.journal_issue = issue.text.strip() if issue is not None and issue.text else ""
        date = article.find(".//JournalIssue/PubDate")
        if date is not None:
            year = date.findtext("Year", "")
            month = date.findtext("Month", "")
            pub.publication_date = "-".join(p for p in (year, month) if p)
        for author in article.findall(".//AuthorList/Author"):
            surname = author.findtext("LastName", "")
            initials = author.findtext("Initials", "")
            if surname:
                pub.authors.append((surname, initials))
        for mesh in article.findall(".//MeshHeadingList/MeshHeading"):
            descriptor = mesh.find("DescriptorName")
            if descriptor is not None:
                pub.mesh_codes.append(
                    (descriptor.get("UI", ""), (descriptor.text or "").strip())
                )
        for chem in article.findall(".//ChemicalList/Chemical/NameOfSubstance"):
            pub.chemicals.append((chem.get("UI", ""), (chem.text or "").strip()))
        for doi in article.findall(".//ArticleId"):
            if doi.get("IdType") == "doi" and doi.text:
                pub.doi = doi.text.strip()
        out[pub.pmid] = pub
    return out


def parse_elink_citation_xml(xml_text: str) -> Dict[str, Set[str]]:
    """Parse an elink pubmed_pubmed_citedin reply: pmid -> citing pmids."""
    out: Dict[str, Set[str]] = {}
    try:
        root = ET.fromstring(xml_text.encode())
    except ET.ParseError as exc:
        log().warn("pubmed elink XML parse error: {}", exc)
        return out
    for linkset in root.iter("LinkSet"):
        id_node = linkset.find("./IdList/Id")
        if id_node is None or not id_node.text:
            continue
        pmid = id_node.text.strip()
        cited_by = {
            link.text.strip()
            for db in linkset.findall("LinkSetDb")
            if db.findtext("LinkName", "") == "pubmed_pubmed_citedin"
            for link in db.findall("./Link/Id")
            if link.text
        }
        out[pmid] = cited_by
    return out


# --------------------------------------------------------------------------- #
# requester with cache
# --------------------------------------------------------------------------- #
class PubmedRequester:
    """The app resource: batched lookups with a write-through disk cache.

    If network access is unavailable (the default in air-gapped runs) the
    requester is cache-only and logs uncached pmids.
    """

    EFETCH_URL = "https://eutils.ncbi.nlm.nih.gov/entrez/eutils/efetch.fcgi"
    ELINK_URL = "https://eutils.ncbi.nlm.nih.gov/entrez/eutils/elink.fcgi"

    def __init__(self, identifier: str, cache_directory: str = "",
                 api_key: str = "", allow_network: bool = False):
        self.identifier = identifier
        self.cache_directory = cache_directory
        self.api_key = api_key
        self.allow_network = allow_network
        self._publications: Dict[str, PublicationSummary] = {}
        self._citations: Dict[str, Set[str]] = {}
        if cache_directory:
            self._load_cache()

    # --- cache ------------------------------------------------------------
    def _cache_path(self, name: str) -> str:
        return os.path.join(self.cache_directory, name)

    def _load_cache(self) -> None:
        pub_path = self._cache_path(PUBLICATION_CACHE)
        if os.path.isfile(pub_path):
            with open(pub_path) as f:
                for chunk in f.read().split("<!--CACHE-RECORD-->"):
                    if chunk.strip():
                        self._publications.update(parse_pubmed_article_xml(chunk.strip()))
        cite_path = self._cache_path(CITATION_CACHE)
        if os.path.isfile(cite_path):
            with open(cite_path) as f:
                for chunk in f.read().split("<!--CACHE-RECORD-->"):
                    if chunk.strip():
                        self._citations.update(parse_elink_citation_xml(chunk.strip()))
        if self._publications or self._citations:
            log().info("pubmed cache: {} publications, {} citation sets",
                       len(self._publications), len(self._citations))

    def _append_cache(self, name: str, xml_text: str) -> None:
        if not self.cache_directory:
            return
        os.makedirs(self.cache_directory, exist_ok=True)
        with open(self._cache_path(name), "a") as f:
            f.write(xml_text)
            f.write("\n<!--CACHE-RECORD-->\n")

    # --- network (gated) --------------------------------------------------
    def _http_get(self, url: str, params: Dict[str, str]) -> Optional[str]:
        if not self.allow_network:
            return None
        import urllib.parse
        import urllib.request

        query = urllib.parse.urlencode(params)
        try:
            with urllib.request.urlopen(f"{url}?{query}", timeout=30) as resp:
                return resp.read().decode()
        except OSError as exc:
            log().warn("pubmed request failed: {}", exc)
            return None

    # --- public API -------------------------------------------------------
    def get_publications(self, pmids: Iterable[str]) -> Dict[str, PublicationSummary]:
        """Publication details for pmids (getPublicationDetails); batched
        network fill of cache misses when networking is allowed."""
        wanted = list(dict.fromkeys(pmids))
        found = {p: self._publications[p] for p in wanted if p in self._publications}
        missing = [p for p in wanted if p not in found]
        if missing and self.allow_network:
            for start in range(0, len(missing), EFETCH_BATCH):
                batch = missing[start : start + EFETCH_BATCH]
                params = {"db": "pubmed", "retmode": "xml", "id": ",".join(batch)}
                if self.api_key:
                    params["api_key"] = self.api_key
                reply = self._http_get(self.EFETCH_URL, params)
                if reply:
                    parsed = parse_pubmed_article_xml(reply)
                    self._publications.update(parsed)
                    found.update(parsed)
                    self._append_cache(PUBLICATION_CACHE, reply)
                time.sleep(BATCH_DELAY_S)
        elif missing:
            log().info("pubmed: {} pmids not in cache (network disabled)", len(missing))
        # Attach citation sets.
        for pmid, pub in found.items():
            if pmid in self._citations:
                pub.cited_by = set(self._citations[pmid])
        return found

    def get_citations(self, pmids: Iterable[str]) -> Dict[str, Set[str]]:
        wanted = list(dict.fromkeys(pmids))
        found = {p: self._citations[p] for p in wanted if p in self._citations}
        missing = [p for p in wanted if p not in found]
        if missing and self.allow_network:
            for start in range(0, len(missing), ELINK_BATCH):
                batch = missing[start : start + ELINK_BATCH]
                params = {
                    "dbfrom": "pubmed", "linkname": "pubmed_pubmed_citedin",
                    "id": ",".join(batch),
                }
                if self.api_key:
                    params["api_key"] = self.api_key
                reply = self._http_get(self.ELINK_URL, params)
                if reply:
                    parsed = parse_elink_citation_xml(reply)
                    self._citations.update(parsed)
                    found.update(parsed)
                    self._append_cache(CITATION_CACHE, reply)
                time.sleep(BATCH_DELAY_S)
        return found
