"""Server CLI: serve the work API/UI, run cron jobs, and ops tooling.

The reference spreads these across an Apache vhost (web/), crontab
entries (INSTALL.md:47-52), and hand-run misc/ scripts; here one entry
point covers them:

    python -m dwpa_tpu_torch.server serve --db wpa.db --port 8080 \
        [--precrack-device auto|off|cpu]
    python -m dwpa_tpu_torch.server jobs  --db wpa.db [--loop]
    python -m dwpa_tpu_torch.server ks-add --db wpa.db --ssid-re .. --pass-re ..
    python -m dwpa_tpu_torch.server ks-list --db wpa.db
    python -m dwpa_tpu_torch.server recrack --db wpa.db
    python -m dwpa_tpu_torch.server pack-dict --db wpa.db words.txt --name top1k
    python -m dwpa_tpu_torch.server dedup-dicts a.txt.gz b.txt.gz [--db wpa.db]
    python -m dwpa_tpu_torch.server fill-pr --db wpa.db
    python -m dwpa_tpu_torch.server enrich  --db wpa.db

The pre-crack derives PMKs on ``cuda:0`` by default and refuses to start
without a card; ``--precrack-device off`` derives on the host.
"""

import argparse
import json
import re
import sys
import time


def _load_conf(args):
    """Overlay a JSON conf file (the web/conf.php equivalent surface:
    db path, artifact dirs, bosskey, bind address, public base_url)
    under any explicitly passed flags — flags win."""
    path = getattr(args, "conf", None)
    if not path:
        return {}
    with open(path) as f:
        conf = json.load(f)
    for key in ("db", "dictdir", "capdir", "hcdir", "bosskey", "host",
                "port", "base_url", "capture_cap"):
        if key in conf and getattr(args, key, None) is None:
            setattr(args, key, conf[key])
    return conf


def _core(args):
    from .core import ServerCore
    from .db import Database

    _load_conf(args)
    if not getattr(args, "db", None):
        raise SystemExit("--db (or a conf file with a 'db' key) is required")
    core = ServerCore(
        Database(args.db),
        dictdir=getattr(args, "dictdir", None) or "dicts",
        capdir=getattr(args, "capdir", None) or "caps",
        bosskey=getattr(args, "bosskey", None),
        hcdir=getattr(args, "hcdir", None),
        base_url=getattr(args, "base_url", None) or "",
        capture_cap=getattr(args, "capture_cap", None),
        max_inflight=getattr(args, "max_inflight", None),
        use_queue=not getattr(args, "no_work_queue", False),
    )
    if getattr(args, "recaptcha_secret", None):
        from .external import RECAPTCHA_URL, RecaptchaVerifier

        core.captcha = RecaptchaVerifier(
            args.recaptcha_secret,
            url=getattr(args, "recaptcha_url", None) or RECAPTCHA_URL,
        )
    if getattr(args, "mx_check", False):
        from .external import mx_email_validator

        core.email_check = mx_email_validator()
    return core


def cmd_serve(args):
    import socketserver
    from wsgiref.simple_server import WSGIServer, make_server

    from .api import make_wsgi_app

    class ThreadingWSGIServer(socketserver.ThreadingMixIn, WSGIServer):
        """One thread per request, like the reference under Apache
        prefork: a slow capture upload must not block get_work for the
        whole fleet.  Database serializes statements; get_work holds the
        scheduler mutex (core.py).  Concurrent request handling is
        capped (Apache's MaxClients analog) so N hostile uploads cannot
        hold N x 64 MiB request bodies in memory at once — excess
        connections queue on the semaphore.
        """

        daemon_threads = True
        max_concurrent = 16
        request_timeout = 120.0  # reference client's socket timeout

        def process_request(self, request, client_address):
            # Acquire in the accept loop, BEFORE spawning the handler
            # thread: resources (threads, fds, bodies) are bounded at
            # the accept layer; excess connections wait in the kernel
            # listen backlog, exactly like Apache at MaxClients.
            self._request_slots.acquire()
            try:
                super().process_request(request, client_address)
            except Exception:
                self._request_slots.release()
                raise

        def process_request_thread(self, request, client_address):
            try:
                # An idle/stalled peer must not hold its slot forever —
                # reads time out, the handler errors, the slot frees.
                request.settimeout(self.request_timeout)
                super().process_request_thread(request, client_address)
            finally:
                self._request_slots.release()

        def server_activate(self):
            import threading

            self._request_slots = threading.BoundedSemaphore(
                self.max_concurrent
            )
            super().server_activate()

    from ..obs import setup_logging

    setup_logging()
    serve_core = _core(args)
    if not getattr(args, "no_precrack_ingest", False):
        # Ingestion-time pre-crack: add_hashlines hands freshly inserted
        # net ids to this engine AFTER the ingest tx commits, so every
        # new net gets its vendor/IMEI/replay candidate sweep before any
        # client ever leases it.
        from .precrack import PrecrackEngine

        serve_core.precrack = PrecrackEngine(
            serve_core, batch=args.precrack_batch,
            device=args.precrack_device,
            dict_limit=args.precrack_dict_limit)
    app = make_wsgi_app(serve_core)
    if getattr(args, "with_jobs", False):
        # The cron layer in-process: its own ServerCore (sqlite handles
        # are not shared across threads; WAL serializes the writers).
        import threading

        if args.db == ":memory:":
            raise SystemExit("--with-jobs needs a file-backed --db "
                             "(a second :memory: handle would be empty)")
        jobs_core = _core(args)
        geo, psk = _job_lookups(args)  # validate sources before the thread
        threading.Thread(
            target=_jobs_loop, args=(jobs_core, args, geo, psk), daemon=True
        ).start()
    host = args.host or "127.0.0.1"
    port = args.port if args.port is not None else 8080
    with make_server(host, port, app,
                     server_class=ThreadingWSGIServer) as srv:
        mat = _start_materializer(serve_core)
        print(f"dwpa_tpu_torch server on http://{host}:{port}/", flush=True)
        try:
            srv.serve_forever()
        finally:
            if mat is not None:
                thread, stop = mat
                stop.set()
                thread.join(timeout=5.0)


def _start_materializer(core, interval: float = 1.0):
    """Background issuable-queue refill for ``serve``: keeps get_work on
    the O(1) pop path instead of the inline refill scan.  No-op when the
    queue is disabled (--no-work-queue).

    Returns ``(thread, stop)`` or None; setting ``stop`` ends the loop
    within one tick and the thread can then be joined — the thread-
    lifecycle rule every spawn in this repo follows (daemon=True is the
    backstop for serve_forever's hard exit, not the shutdown story)."""
    import threading

    if core.queue is None:
        return None

    stop = threading.Event()

    def loop():
        while not stop.is_set():
            try:
                core.materialize_queue()
            except Exception:
                pass  # transient sqlite contention: next tick retries
            stop.wait(interval)

    t = threading.Thread(target=loop, daemon=True,
                         name="dwpa-queue-materializer")
    t.start()
    return t, stop


def _geo_lookup_from_file(path):
    """Offline geolocation source (a wigle CSV/JSON export): JSON object
    ``{"aabbccddeeff": {"lat": .., "lon": .., "country": ..}, ...}``."""
    with open(path) as f:
        table = {k.lower(): v for k, v in json.load(f).items()}
    return lambda mac: table.get(mac.hex())


def _psk_lookup_from_file(path):
    """Offline PSK-database source (a 3wifi-style dump): lines of
    ``aabbccddeeff:psk``.  Answers still go through full server-side
    re-verification — the file is never trusted."""
    table = {}
    with open(path, "rb") as f:
        for ln in f:
            mac, _, psk = ln.rstrip(b"\r\n").partition(b":")
            if len(mac) == 12 and psk:
                try:
                    table[bytes.fromhex(mac.decode())] = psk
                except (ValueError, UnicodeDecodeError):
                    pass  # header/junk line, skip like any malformed row
    return lambda macs: {m: table[m] for m in macs if m in table}


def _job_lookups(args):
    """Build the geo/PSK lookup callables — ONCE, and before any
    background thread starts, so a bad path, malformed file, or missing
    API key fails the command loudly instead of silently killing the
    cron layer.  Offline file sources win over live API adapters when
    both are configured (airgapped deployments stay airgapped)."""
    geo = psk = None
    if getattr(args, "wigle_api", None):
        from .external import WIGLE_URL, WigleClient

        geo = WigleClient(args.wigle_api,
                          url=getattr(args, "wigle_url", None) or WIGLE_URL)
    if getattr(args, "wifi3_api", None):
        from .external import WIFI3_URL, ThreeWifiClient

        psk = ThreeWifiClient(args.wifi3_api,
                              url=getattr(args, "wifi3_url", None) or WIFI3_URL)
    if args.geo_file:
        geo = _geo_lookup_from_file(args.geo_file)
    if args.psk_file:
        psk = _psk_lookup_from_file(args.psk_file)
    return geo, psk


def _keygen_gens(args):
    """``extra_generators`` for keygen precompute: the built-in vendor
    families, plus any deployment data pack (``--vendor-data``).  None
    keeps keygen_precompute's default (built-ins only)."""
    path = getattr(args, "vendor_data", None)
    if not path:
        return None
    from ..gen.vendor_data import load_vendor_pack
    from ..gen.vendors import vendor_candidates

    return [vendor_candidates] + load_vendor_pack(path)


def cmd_jobs(args):
    """The cron layer: one shot of maintenance + keygen (+ geolocation /
    PSK lookup when a source is configured) by default, or continuous
    with --loop (maintenance hourly, keygen every 5 min, enrichment every
    10 min — the INSTALL.md:47-52 cadence)."""
    from ..obs import setup_logging
    from .jobs import (geolocate, keygen_precompute, maintenance, precrack,
                       psk_lookup)

    setup_logging()
    core = _core(args)
    geo, psk = _job_lookups(args)
    if not args.loop:
        out = {"maintenance": maintenance(core),
               "keygen": keygen_precompute(
                   core, extra_generators=_keygen_gens(args)),
               "precrack": precrack(
                   core, limit=args.precrack_limit,
                   batch=args.precrack_batch,
                   device=args.precrack_device,
                   dict_limit=args.precrack_dict_limit)}
        if geo:
            out["geolocate"] = geolocate(core, geo)
        if psk:
            out["psk_lookup"] = psk_lookup(core, psk)
        print(json.dumps(out, default=str))
        return
    _jobs_loop(core, args, geo, psk)


def _jobs_loop(core, args, geo, psk):
    """The continuous cron layer (INSTALL.md:47-52 cadence); shared by
    ``jobs --loop`` and ``serve --with-jobs``.  Transient job errors
    (sqlite lock contention, I/O hiccups) are logged and retried next
    tick — one bad pass must not end the cron layer for good."""
    from ..obs import get_logger
    from .jobs import (geolocate, keygen_precompute, maintenance, precrack,
                       psk_lookup)

    log = get_logger("server.jobs")
    gens = _keygen_gens(args)
    last_maint = last_enrich = last_precrack = 0.0
    while True:
        now = time.time()
        try:
            if now - last_maint >= args.maint_interval:
                maintenance(core)
                last_maint = now
            if (geo or psk) and now - last_enrich >= args.enrich_interval:
                if geo:
                    geolocate(core, geo)
                if psk:
                    psk_lookup(core, psk)
                last_enrich = now
            if now - last_precrack >= args.precrack_interval:
                precrack(core, limit=args.precrack_limit,
                         batch=args.precrack_batch,
                         device=args.precrack_device,
                         dict_limit=args.precrack_dict_limit)
                last_precrack = now
            keygen_precompute(core, extra_generators=gens)
        except Exception:
            log.exception("jobs tick failed (will retry)")
        time.sleep(args.keygen_interval)


def cmd_recrack(args):
    from .tools import recrack_verify

    print(json.dumps(recrack_verify(_core(args), limit=args.limit)))


def cmd_pack_dict(args):
    from .tools import pack_dict

    rules = None
    if args.default_rules:
        from ..rules import wpa_rules_text

        rules = wpa_rules_text()
    elif args.rules:
        with open(args.rules) as f:
            rules = f.read()
    print(json.dumps(pack_dict(_core(args), args.source, args.name, rules=rules)))


def cmd_dedup_dicts(args):
    from .tools import dedup_dicts

    core = _core(args) if args.db else None
    print(json.dumps(dedup_dicts(args.paths, core=core)))


def cmd_fill_pr(args):
    from .tools import fill_pr, get_extractor

    ex = get_extractor(native=args.native)
    print(json.dumps(fill_pr(_core(args), limit=args.limit, extractor=ex)))


def cmd_enrich(args):
    from .tools import enrich_message_pair, get_extractor

    ex = get_extractor(native=args.native)
    print(json.dumps(
        enrich_message_pair(_core(args), limit=args.limit, extractor=ex)))


def cmd_ks_add(args):
    from ..keyspace import KeyspaceError

    try:
        row = _core(args).ks_add(args.ssid_re, args.pass_re,
                                 priority=args.priority,
                                 enabled=not args.disabled)
    except KeyspaceError as e:
        # Loud rejection is the dialect's contract: a pattern the
        # compiler can't cover exactly must never be half-scheduled.
        raise SystemExit(f"pass-regex rejected: {e}")
    except re.error as e:
        raise SystemExit(f"bad --ssid-re: {e}")
    print(json.dumps(row))


def cmd_ks_list(args):
    core = _core(args)
    out = []
    for row in core.ks_rows(enabled_only=False):
        d = dict(row)
        d["keyspace"] = core._ks_cache.keyspace(row["pass_regex"])
        out.append(d)
    print(json.dumps(out))


def cmd_reorder_captures(args):
    from .tools import reorder_captures

    print(json.dumps(reorder_captures(_core(args))))


def cmd_pack_client(args):
    from .tools import pack_client

    _load_conf(args)
    if not args.hcdir:
        raise SystemExit("--hcdir (or a conf file with an 'hcdir' key) "
                         "is required")
    print(json.dumps(pack_client(args.hcdir, version=args.version)))


def cmd_migrate(args):
    """Legacy hccapx / 16800-PMKID storage -> m22000 nets rows.

    Input: a file of newline-separated legacy PMKID lines, a single
    hccapx capture file (393-byte records back to back), or both.
    """
    from .tools import HCCAPX_LEN, migrate_legacy

    records = []
    for path in args.sources:
        with open(path, "rb") as f:
            blob = f.read()
        if blob[:4] == b"HCPX":
            records += [blob[i:i + HCCAPX_LEN]
                        for i in range(0, len(blob), HCCAPX_LEN)]
        else:
            records += [ln for ln in blob.splitlines() if ln.strip()]
    print(json.dumps(migrate_legacy(
        _core(args), records, verify=not args.no_verify), default=str))


def main(argv=None):
    p = argparse.ArgumentParser(prog="dwpa_tpu_torch.server")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, db_required=True):
        sp.add_argument("--db", help="sqlite path")
        sp.add_argument("--conf", help="JSON conf file (web/conf.php "
                                       "equivalent); flags override it")
        sp.add_argument("--dictdir")
        sp.add_argument("--capdir")

    def jobs_flags(sp):
        """Cron-layer knobs, shared by `jobs` and `serve --with-jobs`."""
        sp.add_argument("--maint-interval", type=float, default=3600)
        sp.add_argument("--keygen-interval", type=float, default=300)
        sp.add_argument("--enrich-interval", type=float, default=600,
                        help="geolocate/psk-lookup cadence (wigle.php/"
                             "3wifi.php run every 10 min)")
        sp.add_argument("--geo-file", help="offline geolocation JSON "
                                           "{mac_hex: {lat, lon, ...}}")
        sp.add_argument("--psk-file", help="offline PSK database, lines of "
                                           "mac_hex:psk (3wifi-dump style)")
        sp.add_argument("--wigle-api", help="wigle.net Basic-auth API key "
                                            "(live geolocation, wigle.php)")
        sp.add_argument("--wigle-url", help="override the wigle endpoint "
                                            "(stub testing)")
        sp.add_argument("--wifi3-api", help="3wifi API key (live PSK "
                                            "lookups, 3wifi.php)")
        sp.add_argument("--wifi3-url", help="override the 3wifi endpoint "
                                            "(stub testing)")
        sp.add_argument("--vendor-data",
                        help="JSON vendor keygen pack (gen/vendor_data.py "
                             "format): adds data-driven routerkeygen "
                             "families to keygen precompute")
        sp.add_argument("--precrack-interval", type=float, default=300,
                        help="server-side pre-crack sweep cadence in "
                             "seconds (fused mixed-ESSID PMK derivation "
                             "over every unprocessed net's candidates)")
        sp.add_argument("--precrack-batch", type=int, default=2048,
                        help="fused PMK derivation width per pre-crack "
                             "wave (sched/fuse.py static widths)")
        sp.add_argument("--precrack-device", default="auto",
                        help="where pre-crack PMKs derive: auto/on = "
                             "cuda:0 (refuses to start without a card), "
                             "off = host PBKDF2 (bit-identical), or a "
                             "torch device such as cpu or cuda:1")
        sp.add_argument("--precrack-limit", type=int, default=100,
                        help="max unprocessed nets per pre-crack sweep")
        sp.add_argument("--precrack-dict-limit", type=int, default=64,
                        help="top-N cracked-corpus passwords replayed per "
                             "pre-crack sweep (0 disables the dict source)")
        sp.add_argument("--no-precrack-ingest", action="store_true",
                        help="don't sweep new nets synchronously at "
                             "capture ingestion (the recurring job still "
                             "covers them on --precrack-interval)")

    sp = sub.add_parser("serve", help="run the HTTP API + UI")
    common(sp)
    sp.add_argument("--host", default=None, help="bind address (default 127.0.0.1)")
    sp.add_argument("--port", type=int, default=None,
                    help="port (default 8080; 0 = OS-assigned)")
    sp.add_argument("--base-url", dest="base_url", help="public URL for mailed links")
    sp.add_argument("--bosskey", help="32-hex superuser key (conf.php)")
    sp.add_argument("--hcdir", help="client-distribution dir (web/hc/): "
                                    "dwpa_tpu.version + dwpa_tpu.pyz")
    sp.add_argument("--capture-cap", dest="capture_cap", type=int, default=None,
                    help="capture upload size bound in bytes, raw and "
                         "gzip-decompressed (default 8 MiB — the reference's "
                         "deployment-tunable PHP upload limit)")
    sp.add_argument("--max-inflight", dest="max_inflight", type=int,
                    default=None,
                    help="admission-control cap on live leases; extra "
                         "get_work calls get HTTP 429 + Retry-After "
                         "(default 4096, 0 disables)")
    sp.add_argument("--no-work-queue", dest="no_work_queue",
                    action="store_true",
                    help="disable the precomputed issuable-unit queue and "
                         "fall back to per-request table scans")
    sp.add_argument("--with-jobs", action="store_true",
                    help="run the cron layer as a background thread of "
                         "this process (single-process deployment)")
    sp.add_argument("--recaptcha-secret",
                    help="enable reCAPTCHA siteverify on key issue "
                         "(index.php:16-35)")
    sp.add_argument("--recaptcha-url", help="override the siteverify "
                                            "endpoint (stub testing)")
    sp.add_argument("--mx-check", action="store_true",
                    help="DNS MX probe on e-mail validation "
                         "(validEmail, common.php:981-992)")
    jobs_flags(sp)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("jobs", help="run maintenance + keygen precompute")
    common(sp)
    sp.add_argument("--loop", action="store_true")
    jobs_flags(sp)
    sp.set_defaults(fn=cmd_jobs)

    sp = sub.add_parser("recrack", help="re-verify every cracked net")
    common(sp)
    sp.add_argument("--limit", type=int)
    sp.set_defaults(fn=cmd_recrack)

    sp = sub.add_parser("pack-dict", help="package a wordlist for serving")
    common(sp)
    sp.add_argument("source", help="input wordlist (.txt or .txt.gz)")
    sp.add_argument("--name", required=True, help="served dict name")
    sp.add_argument("--rules", help="hashcat rules file to attach")
    sp.add_argument("--default-rules", action="store_true",
                    help="attach the bundled WPA ruleset (rules/wpa.rule)")
    sp.set_defaults(fn=cmd_pack_dict)

    sp = sub.add_parser("dedup-dicts", help="cross-dict dedup, earlier wins")
    sp.add_argument("paths", nargs="+")
    sp.add_argument("--db", help="also refresh dicts rows")
    sp.add_argument("--dictdir")
    sp.add_argument("--capdir")
    sp.set_defaults(fn=cmd_dedup_dicts)

    sp = sub.add_parser("fill-pr", help="backfill probe-request tables")
    common(sp)
    sp.add_argument("--limit", type=int)
    sp.add_argument("--native", action="store_true",
                    help="use the C++ bulk parser (native/capture_fast)")
    sp.set_defaults(fn=cmd_fill_pr)

    sp = sub.add_parser("enrich", help="backfill message_pair from captures")
    common(sp)
    sp.add_argument("--limit", type=int)
    sp.add_argument("--native", action="store_true",
                    help="use the C++ bulk parser (native/capture_fast)")
    sp.set_defaults(fn=cmd_enrich)

    sp = sub.add_parser("ks-add",
                        help="add a smart-keyspace rule: nets whose SSID "
                             "matches --ssid-re get mask shards compiled "
                             "from --pass-re scheduled alongside dicts")
    common(sp)
    sp.add_argument("--ssid-re", required=True,
                    help="SSID filter (re.search semantics; anchor with "
                         "^...$ for an exact match)")
    sp.add_argument("--pass-re", required=True,
                    help="password pattern in the bounded dialect "
                         "(literals, [...], \\d, {n}/{m,n}/?, top-level "
                         "|); anything else is rejected loudly")
    sp.add_argument("--priority", type=int, default=0,
                    help="higher priorities are planned first")
    sp.add_argument("--disabled", action="store_true",
                    help="insert the rule disabled (enable later in SQL)")
    sp.set_defaults(fn=cmd_ks_add)

    sp = sub.add_parser("ks-list",
                        help="list smart-keyspace rules with compiled "
                             "keyspace sizes")
    common(sp)
    sp.set_defaults(fn=cmd_ks_list)

    sp = sub.add_parser("reorder-captures",
                        help="migrate a flat capture archive to the dated "
                             "CAP/Y/m/d layout (misc/reorder_by_date.sh)")
    common(sp)
    sp.set_defaults(fn=cmd_reorder_captures)

    sp = sub.add_parser("pack-client",
                        help="build the hc/ self-update artifacts "
                             "(dwpa_tpu.pyz + version manifest)")
    sp.add_argument("--conf", help="JSON conf file (supplies hcdir)")
    sp.add_argument("--hcdir", help="output dir served at /hc/")
    sp.add_argument("--version", help="override the advertised version")
    sp.set_defaults(fn=cmd_pack_client)

    sp = sub.add_parser("migrate",
                        help="convert legacy hccapx/16800 storage to m22000")
    common(sp)
    sp.add_argument("sources", nargs="+",
                    help="hccapx file(s) and/or legacy PMKID line file(s)")
    sp.add_argument("--no-verify", action="store_true",
                    help="skip the post-migration recrack pass")
    sp.set_defaults(fn=cmd_migrate)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
