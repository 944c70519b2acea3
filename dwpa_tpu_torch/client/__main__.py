"""CLI: ``python -m dwpa_tpu_torch.client --url <server-url> [options]``.

Flag set mirrors the reference client's argparse surface
(help_crack.py:975-990): ``-ad`` additional dictionary, ``-pot`` potfile
path, plus engine knobs and ``--device`` (default ``cuda:0``; the client
refuses to start without a card unless ``--device cpu`` is given).

The JAX client's flags for features the port does not have yet are
accepted by the parser and refused with a message naming the missing
piece, so a volunteer's command line never silently loses a knob.
"""

import argparse

from .main import ClientConfig, TpuCrackClient

#: flag dest -> (flag, what is missing)
DEFERRED = {
    "rule_workers": ("--rule-workers", "host rule expansion and on-device "
                     "rules (ROADMAP later slice 3)"),
    "pmk_cache_dir": ("--pmk-cache-dir", "the PMK store (ROADMAP later slice 4)"),
    "pmk_cache_max_bytes": ("--pmk-cache-max-bytes",
                            "the PMK store (ROADMAP later slice 4)"),
    "dict_cache_dir": ("--dict-cache-dir",
                       "the packed-dictionary cache (ROADMAP item DictCache)"),
    "dict_cache_max_bytes": ("--dict-cache-max-bytes",
                             "the packed-dictionary cache (ROADMAP item DictCache)"),
    "unit_queue": ("--unit-queue", "unit fusion (ROADMAP later slice 5)"),
    "fuse_max_units": ("--fuse-max-units", "unit fusion (ROADMAP later slice 5)"),
    "multihost": ("--multihost", "multi-host slices (ROADMAP later slice 10)"),
    "coordinator": ("--coordinator", "multi-host slices (ROADMAP later slice 10)"),
    "num_processes": ("--num-processes", "multi-host slices (ROADMAP later slice 10)"),
    "process_id": ("--process-id", "multi-host slices (ROADMAP later slice 10)"),
}


def build_parser():
    p = argparse.ArgumentParser(
        prog="dwpa_tpu_torch.client",
        description="dwpa volunteer client with a PyTorch/CUDA m22000 cracker",
    )
    p.add_argument("--url", required=True,
                   help="dwpa server base URL (e.g. https://wpa-sec.example/)")
    p.add_argument("--device", default=None,
                   help="torch device to crack on (default cuda:0; 'cpu' runs "
                        "the plain torch PBKDF2, for tests only)")
    p.add_argument("-ad", "--additional-dict", help="extra local dictionary (pass 1)")
    p.add_argument("-pot", "--potfile", help="potfile path for founds")
    p.add_argument("-w", "--workdir", default="hc_work", help="working directory")
    p.add_argument("-d", "--dictcount", type=int, default=1, help="initial dict count 1..15")
    p.add_argument("-b", "--batch-size", type=int, default=16384, help="device batch size")
    p.add_argument("-n", "--max-work-units", type=int, default=0, help="stop after N units")
    p.add_argument("--nc", type=int, default=8,
                   help="nonce-error-correction budget (reference -co "
                        "--nonce-error-corrections, help_crack.py:773)")
    p.add_argument("--feed-depth", type=int, default=2,
                   help="candidate-feed queue depth: blocks framed/packed "
                        "ahead of the engine")
    p.add_argument("--feed-workers", type=int, default=None,
                   help="candidate-feed producer threads running the host "
                        "stages off the crack loop (default 1; 0 = inline "
                        "feed, no threads)")
    p.add_argument("--device-streams", choices=("auto", "on", "off"),
                   default="auto",
                   help="'on' (independent per-device streams) is not "
                        "ported yet; auto/off crack on the one device")
    p.add_argument("--max-tries", type=int, default=0,
                   help="transport attempts per server call before giving "
                        "up (0 = retry forever, reference behavior)")
    p.add_argument("--backoff", type=float, default=123.0,
                   help="retry base delay in seconds, also the idle "
                        "(No nets) nap (reference interval 123)")
    p.add_argument("--retry-cap", type=float, default=None,
                   help="max retry delay for the decorrelated-jitter "
                        "exponential backoff (default: flat at --backoff)")
    p.add_argument("--outbox-dir",
                   help="durable found-outbox directory: cracked PSKs "
                        "are journaled there before submission and "
                        "drained at startup/between units (default: "
                        "<workdir>/outbox)")
    p.add_argument("--prefetch-units", type=int, default=0,
                   help="extra work units leased ahead while the server "
                        "is reachable and cracked while the transport "
                        "circuit is OPEN (degraded mode; 0 = off)")
    for dest, (flag, _) in DEFERRED.items():
        if dest == "multihost":
            p.add_argument(flag, dest=dest, action="store_true",
                           help="not ported yet")
        else:
            p.add_argument(flag, dest=dest, default=None, help="not ported yet")
    return p


def main(argv=None):
    from ..obs import setup_logging

    setup_logging()  # console format preserved; DWPA_LOG=json for pipelines
    parser = build_parser()
    args = parser.parse_args(argv)
    for dest, (flag, missing) in DEFERRED.items():
        if getattr(args, dest) not in (None, False):
            parser.error(f"{flag}: {missing} is not ported to dwpa_tpu_torch yet")
    if args.device_streams == "on":
        parser.error("--device-streams on: per-device streams are not ported "
                     "to dwpa_tpu_torch yet (ROADMAP later slice 6)")
    cfg = ClientConfig(
        base_url=args.url,
        workdir=args.workdir,
        dictcount=args.dictcount,
        batch_size=args.batch_size,
        additional_dict=args.additional_dict,
        potfile=args.potfile,
        max_work_units=args.max_work_units,
        nc=args.nc,
        feed_depth=args.feed_depth,
        feed_workers=args.feed_workers,
        device_streams=args.device_streams,
        max_tries=args.max_tries,
        backoff=args.backoff,
        retry_cap=args.retry_cap,
        outbox_dir=args.outbox_dir,
        prefetch_units=args.prefetch_units,
        device=args.device,
    )
    TpuCrackClient(cfg).run()


if __name__ == "__main__":
    main()
