"""Ops & migration tooling — the reference's ``misc/`` scripts as library
functions (CLI in server/__main__.py):

- ``recrack_verify``   — re-verify every cracked net from its stored
  pass/pmk/nc and abort on the first mismatch, the safety net the
  reference runs after storage migration (misc/migrate_to_m22000.php:
  121-141, ``die('Recrack failed!')``);
- ``pack_dict``        — package a wordlist into the served ``.txt.gz``
  form: deterministic gzip -9, md5 manifest, dicts-table row
  (misc/create_gz.sh:27-35);
- ``dedup_dicts``      — cross-dictionary dedup, earlier dicts win,
  output ordered shortest-word-first (misc/dedup.sh:4-24);
- ``fill_pr``          — backfill PROBEREQUEST tables by re-parsing
  archived captures (misc/fill_pr.php:33-71);
- ``enrich_message_pair`` — upgrade stored hashlines missing
  message-pair info by re-parsing their original captures
  (misc/enrich_pmkid.php:44-68).

All functions are idempotent (INSERT OR IGNORE / UNIQUE-keyed writes) so
re-running a partially-completed pass is safe — matching the reference's
at-least-once ops posture (SURVEY.md §5.2).
"""

import gzip
import hashlib
import os
import re

from ..models import hashline as hl
from ..obs import get_logger
from .capture import extract_hashlines
from .core import SERVER_NC, ServerCore
from .db import long2mac
from .precrack import verify_batch

# child of the package logger: one setup_logging() config for every
# emitter (obs/logs.py), ops warnings included
_log = get_logger(__name__)


class RecrackError(RuntimeError):
    """A stored crack failed re-verification (data corruption or a
    storage-migration bug); mirrors the reference's hard abort."""


def recrack_verify(core: ServerCore, limit: int = None) -> dict:
    """Re-verify every cracked net; raise RecrackError on any mismatch.

    Nets with a non-empty stored pass are re-cracked from scratch (full
    PBKDF2 — the migrate_to_m22000.php:121-141 semantics) and the derived
    PMK compared against the stored one; empty-pass nets (ZeroPMK) are
    verified by PMK replay.
    """
    q = "SELECT * FROM nets WHERE n_state = 1"
    args = ()
    if limit:
        q += " LIMIT ?"
        args = (limit,)
    nets = core.db.q(q, args)
    # One batched dispatch for the whole table: non-empty passes derive
    # their PBKDF2 in the fused wave, ZeroPMK rows replay the stored PMK
    # — verdicts identical to the old per-net oracle loop.
    items = []
    for net in nets:
        h = hl.parse(net["struct"])
        if net["pass"]:
            items.append((h, [net["pass"]], None))
        else:
            items.append((h, [net["pass"] or b""], net["pmk"]))
    for net, r in zip(nets, verify_batch(items, nc=SERVER_NC,
                                         batcher=core.verifier)):
        if r is None or (net["pmk"] is not None and r[3] != net["pmk"]):
            raise RecrackError(
                f"net {net['net_id']} ({long2mac(net['bssid']).hex()}): "
                f"stored pass/pmk does not re-crack its hashline"
            )
    return {"checked": len(nets)}


def _read_words(path: str):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        return [ln.rstrip(b"\r\n") for ln in f if ln.strip()]


def _write_gz(path: str, words) -> bytes:
    """Deterministic gzip (mtime=0) so the dhash only moves with content."""
    import io

    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", compresslevel=9, mtime=0) as gz:
        for w in words:
            gz.write(w + b"\n")
    blob = buf.getvalue()
    with open(path, "wb") as f:
        f.write(blob)
    return blob


def pack_dict(core: ServerCore, source, dname: str, rules: str = None) -> dict:
    """Package ``source`` (path or iterable of words) as a served dict.

    Writes ``<dictdir>/<dname>`` (deterministic .txt.gz), registers the
    dicts row with its md5 + wordcount (create_gz.sh emits the same
    INSERT), returns {dpath, dhash, wcount}.
    """
    words = _read_words(source) if isinstance(source, str) else list(source)
    if not dname.endswith(".txt.gz"):
        dname += ".txt.gz"
    os.makedirs(core.dictdir, exist_ok=True)
    path = os.path.join(core.dictdir, dname)
    blob = _write_gz(path, words)
    dhash = hashlib.md5(blob).hexdigest()
    dpath = f"dict/{dname}"
    core.add_dict(dpath, dname, dhash, len(words), rules=rules)
    return {"dpath": dpath, "dhash": dhash, "wcount": len(words)}


def dedup_dicts(paths, core: ServerCore = None) -> dict:
    """Cross-dict dedup: drop words already present in an earlier dict.

    Earlier paths win (the reference pipes successive dicts through
    ``comm -13``, dedup.sh:4-24); each rewritten dict is ordered
    shortest-word-first (cheap candidates first, dedup.sh's final sort).
    When ``core`` is given, matching dicts rows get their dhash/wcount
    refreshed so clients re-download only what changed.
    """
    seen = set()
    stats = {}
    for i, path in enumerate(paths):
        words = _read_words(path)
        kept = []
        local = set()
        for w in words:
            if w not in seen and w not in local:
                kept.append(w)
                local.add(w)
        kept.sort(key=lambda w: (len(w), w))
        seen |= local
        changed = kept != words
        if changed:
            # Rewrite only on real content/order change so dhash — and
            # with it every client's cached copy — stays stable otherwise.
            if path.endswith(".gz"):
                _write_gz(path, kept)
            else:
                with open(path, "wb") as f:
                    f.write(b"\n".join(kept) + (b"\n" if kept else b""))
        stats[path] = {"before": len(words), "after": len(kept)}
        if core is not None and changed:
            dname = os.path.basename(path)
            row = core.db.q1("SELECT d_id FROM dicts WHERE dname = ?", (dname,))
            if row:
                with open(path, "rb") as f:
                    dhash = hashlib.md5(f.read()).hexdigest()
                core.db.x(
                    "UPDATE dicts SET dhash = ?, wcount = ? WHERE d_id = ?",
                    (dhash, len(kept), row["d_id"]),
                )
    return stats


def _archived_captures(core: ServerCore, limit: int = None):
    q = "SELECT s_id, localfile FROM submissions WHERE localfile IS NOT NULL"
    args = ()
    if limit:
        q += " LIMIT ?"
        args = (limit,)
    for row in core.db.q(q, args):
        try:
            with open(row["localfile"], "rb") as f:
                yield row["s_id"], f.read()
        except OSError:
            continue


def get_extractor(native: bool = False):
    """Select the capture extractor: the Python specification parser or
    the C++ fast path (native/capture_fast) for bulk re-parses.  The
    native library is differentially tested against the Python one
    (tests/test_native_capture.py); unavailability falls back silently.
    """
    if native:
        try:
            from ..native import extract_hashlines_fast, load

            if load() is not None:
                return extract_hashlines_fast
        except (ImportError, RuntimeError):
            pass
    return extract_hashlines


def fill_pr(core: ServerCore, limit: int = None, extractor=None) -> dict:
    """Re-parse archived captures into the PROBEREQUEST tables.

    The dynamic-dict source (prs/p2s) for captures ingested before the
    probe-harvest path existed (fill_pr.php:33-71).  INSERT OR IGNORE
    keyed on (ssid) / (p_id, s_id) makes re-runs free.
    """
    extractor = extractor or extract_hashlines
    subs = probes = 0
    for s_id, blob in _archived_captures(core, limit):
        _, prs = extractor(blob)
        if prs:
            core.add_probe_requests(prs, s_id)
            probes += len(prs)
        subs += 1
    return {"submissions": subs, "probes": probes}


def enrich_message_pair(core: ServerCore, limit: int = None,
                        extractor=None) -> dict:
    """Backfill message-pair info on nets whose stored line lacks it.

    Re-parses each archived capture and, for any net matching by m22000
    identity (the hash over fields 1-7, which *excludes* message_pair —
    common.php:310-315), replaces a NULL message_pair with the freshly
    parsed line's value (enrich_pmkid.php:44-68).
    """
    extractor = extractor or extract_hashlines
    updated = 0
    for s_id, blob in _archived_captures(core, limit):
        lines, _ = extractor(blob)
        for line in lines:
            try:
                h = hl.parse(line)
            except ValueError:
                continue
            if h.message_pair is None:
                continue
            row = core.db.q1(
                "SELECT net_id, message_pair FROM nets WHERE hash = ?",
                (h.key_id(),),
            )
            if row and row["message_pair"] is None:
                core.db.x(
                    "UPDATE nets SET message_pair = ?, struct = ? WHERE net_id = ?",
                    (h.message_pair, h.raw, row["net_id"]),
                )
                updated += 1
    return {"updated": updated}


# ---------------------------------------------------------------------------
# Legacy-storage migration (misc/migrate_to_m22000.php)
# ---------------------------------------------------------------------------

HCCAPX_LEN = 393  # fixed struct size (hashcat hccapx v4 format)


def convert_legacy(record) -> str:
    """One legacy stored net -> m22000 hashline string, or None.

    The two pre-m22000 storage forms the reference migrates
    (misc/migrate_to_m22000.php:253-270):

    - a 393-byte hccapx struct ("HCPX" magic): repacked into a TYPE-02
      EAPOL hashline carrying the struct's message_pair verbatim;
    - a legacy PMKID line ``pmkid:mac_ap:mac_sta:essid_hex`` (the
      hcxtools 16800 format): rewritten as a TYPE-01 line with empty
      anonce/eapol/message_pair fields.
    """
    if isinstance(record, str):
        record = record.encode()
    if len(record) == HCCAPX_LEN and record[:4] == b"HCPX":
        mp, essid_len = record[8], record[9]
        essid = record[10 : 10 + min(essid_len, 32)]
        keymic = record[43:59]
        mac_ap = record[59:65]
        nonce_ap = record[65:97]
        mac_sta = record[97:103]
        eapol_len = int.from_bytes(record[135:137], "little")
        eapol = record[137 : 137 + min(eapol_len, 256)]
        return "WPA*02*%s*%s*%s*%s*%s*%s*%02x" % (
            keymic.hex(), mac_ap.hex(), mac_sta.hex(), essid.hex(),
            nonce_ap.hex(), eapol.hex(), mp,
        )
    parts = record.strip().decode("ascii", "replace").split(":")
    if len(parts) == 4 and all(parts):
        return "WPA*01*%s*%s*%s*%s***" % tuple(p.lower() for p in parts)
    return None


def migrate_legacy(core: ServerCore, records, ip: str = "",
                   verify: bool = True) -> dict:
    """Convert legacy records and ingest them through the normal pipeline.

    Mirrors the reference's migration posture: every record goes through
    ``convert_legacy`` then ``add_hashlines`` (hash-identity dedup, zero-
    PMK probe, cross-crack — the same checks fresh captures get), and
    with ``verify`` the migrated DB must pass ``recrack_verify`` before
    the function returns (migrate_to_m22000.php:121-141 aborts the whole
    migration on one recrack failure).
    """
    lines, bad = [], 0
    for rec in records:
        line = convert_legacy(rec)
        if line is None:
            bad += 1
        else:
            lines.append(line)
    res = core.add_hashlines(lines, ip=ip)
    if verify:
        recrack_verify(core)
    return {"converted": len(lines), "unconvertible": bad, **res}


def reorder_captures(core: ServerCore, capdir: str = None) -> dict:
    """Migrate a flat capture archive into the dated CAP/Y/m/d layout.

    The reference stores uploads under CAP/Y/m/d (common.php:492-494)
    and ships misc/reorder_by_date.sh for legacy flat dirs; this is that
    tool: every md5-named file directly under ``capdir`` moves to
    ``Y/m/d`` of its mtime, and matching ``submissions.localfile`` rows
    are rewritten.  Idempotent; files already in dated subdirs are left
    alone.
    """
    import shutil
    import time as _t

    capdir = capdir or core.capdir
    if not capdir or not os.path.isdir(capdir):
        return {"moved": 0, "db_updated": 0}
    moved = updated = 0
    for name in sorted(os.listdir(capdir)):
        src = os.path.join(capdir, name)
        if not os.path.isfile(src) or not re.fullmatch(r"[0-9a-f]{32}", name):
            continue
        day = _t.strftime("%Y/%m/%d", _t.localtime(os.path.getmtime(src)))
        dstdir = os.path.join(capdir, day)
        os.makedirs(dstdir, exist_ok=True)
        dst = os.path.join(dstdir, name)
        shutil.move(src, dst)
        moved += 1
        # Match rows by the md5 basename, not the exact joined path: the
        # server may have stored a different capdir spelling (relative
        # "caps" vs absolute, trailing slash) than this CLI was given,
        # and an exact-match UPDATE would move the file but leave the
        # DB row pointing at the old location.
        updated += core.db.x(
            "UPDATE submissions SET localfile = ? "
            "WHERE localfile = ? OR localfile LIKE ?",
            (dst, src, "%/" + name),
        ).rowcount
    if moved != updated:
        _log.warning(
            "reorder_captures: moved %d files but updated %d submissions "
            "rows — some captures have no (or multiple) DB rows", moved, updated,
        )
    return {"moved": moved, "db_updated": updated}


# ---------------------------------------------------------------------------
# Client distribution (the web/hc/ artifact dir, help_crack.py:158-189)
# ---------------------------------------------------------------------------


def pack_client(hcdir: str, version: str = None) -> dict:
    """Build the self-update artifacts: ``dwpa_tpu.pyz`` + version manifest.

    The reference serves ``hc/help_crack.py`` with a one-line
    ``help_crack.py.version`` next to it; here the client is a package,
    so the artifact is a zipapp of ``dwpa_tpu_torch`` (runnable as
    ``python dwpa_tpu.pyz <server-url>``) and the manifest carries
    ``<version> <archive-md5>`` so the client can integrity-check the
    download (client/main.py:check_update).  The artifact names are the
    protocol's, which every client fetches.
    """
    import re
    import zipfile

    import dwpa_tpu_torch

    version = version or dwpa_tpu_torch.__version__
    # The client's manifest probe only accepts this shape
    # (client/main.py:check_update) — publishing anything else would
    # silently disable updates fleet-wide.
    if not re.fullmatch(r"[0-9]+(\.[0-9]+)*[a-z0-9]*", version):
        raise ValueError(f"version {version!r} would be rejected by the "
                         "client's manifest check")
    pkg_root = os.path.dirname(os.path.abspath(dwpa_tpu_torch.__file__))
    os.makedirs(hcdir, exist_ok=True)
    pyz = os.path.join(hcdir, "dwpa_tpu.pyz")
    count = 0
    with zipfile.ZipFile(pyz, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(pkg_root):
            # sorted: readdir order varies per filesystem, and the md5
            # must be reproducible across hosts serving the same tree
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for name in sorted(files):
                if name.endswith((".pyc", ".so")):
                    continue  # native libs rebuild from the bundled source
                full = os.path.join(root, name)
                rel = "dwpa_tpu_torch/" + os.path.relpath(full, pkg_root).replace(
                    os.sep, "/"
                )  # zipimport requires forward slashes
                # Deterministic archive: fixed timestamp so the md5 (and
                # every client's cached copy) moves only with content.
                info = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
                info.compress_type = zipfile.ZIP_DEFLATED
                with open(full, "rb") as f:
                    z.writestr(info, f.read())
                count += 1
        # __name__ guard: rule-expansion worker processes (spawn) re-import
        # __main__, which must not re-enter the client
        stub = ("if __name__ == '__main__':\n"
                "    from dwpa_tpu_torch.client.__main__ import main\n"
                "    main()\n")
        info = zipfile.ZipInfo("__main__.py", date_time=(1980, 1, 1, 0, 0, 0))
        z.writestr(info, stub)
    with open(pyz, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    with open(os.path.join(hcdir, "dwpa_tpu.version"), "w") as f:
        f.write(f"{version} {md5}\n")
    return {"pyz": pyz, "version": version, "md5": md5, "files": count}
