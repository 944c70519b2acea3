"""CLI: ``python -m dwpa_tpu_torch.client --url <server-url> [options]``.

Flag set mirrors the reference client's argparse surface
(help_crack.py:975-990): ``-ad`` additional dictionary, ``-pot`` potfile
path, plus engine knobs and ``--device`` (default ``cuda:0``; the client
refuses to start without a card unless ``--device cpu`` is given).

A multi-process slice (one volunteer over several processes, each on its
``--device``) joins a ``torch.distributed`` gloo group before any engine
work: ``--coordinator host:port --num-processes N --process-id I`` on
every process (process 0 serves the rendezvous), or ``--multihost`` with
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` in the
environment, as ``torchrun`` sets them.
"""

import argparse
import os

from .main import ClientConfig, TpuCrackClient


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
    p.add_argument("--rule-workers", type=int, default=0,
                   help="processes expanding pass-1 rules (cracked/rkg "
                        "dicts) on the host; pass-2 rules expand on the "
                        "device (0/1 = in-process; ignored with a warning "
                        "on hosts with fewer than N+1 cores)")
    p.add_argument("--pmk-cache-dir",
                   help="persistent PMK store directory: cross-unit "
                        "PBKDF2->PMK cache with mixed hit/miss crack "
                        "blocks (files interchangeable with dwpa_tpu's)")
    p.add_argument("--pmk-cache-max-bytes", type=int,
                   default=256 * 1024 * 1024,
                   help="PMK store on-disk cap; oldest segments are "
                        "evicted beyond it (default 256 MiB)")
    p.add_argument("--dict-cache-dir",
                   help="persistent packed-dictionary cache directory: "
                        "repeat pass-2 dicts are served as pre-packed "
                        "mmap blocks (no gunzip/decode/pack, O(1) resume "
                        "seek; files interchangeable with dwpa_tpu's)")
    p.add_argument("--dict-cache-max-bytes", type=int,
                   default=4 * 1024 * 1024 * 1024,
                   help="dict cache on-disk cap; least-recently-used "
                        "dicts are evicted beyond it (default 4 GiB)")
    p.add_argument("--unit-queue", type=int, default=4,
                   help="work units prefetched ahead of the device by "
                        "the fused multi-unit executor")
    p.add_argument("--fuse-max-units", type=int, default=8,
                   help="max work units packed into one fused device "
                        "batch (one salt-table row per ESSID)")
    p.add_argument("--device-streams", choices=("auto", "on", "off"),
                   default="auto",
                   help="independent per-device crack streams instead of "
                        "lockstep dispatch; auto = on for one process with "
                        "several CUDA devices, lockstep otherwise (one "
                        "card: one stream on cuda:0 with 'on')")
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
    p.add_argument("--multihost", action="store_true",
                   help="join a torch.distributed slice (gloo) through "
                        "env:// before any engine work; the slice then acts "
                        "as ONE volunteer — process 0 owns the server "
                        "conversation")
    p.add_argument("--coordinator",
                   help="slice coordinator host:port (implies --multihost; "
                        "pair with --num-processes and --process-id)")
    p.add_argument("--num-processes", type=int, help="slice size")
    p.add_argument("--process-id", type=int, help="this process's rank")
    return p


def main(argv=None):
    from ..obs import setup_logging

    setup_logging()  # console format preserved; DWPA_LOG=json for pipelines
    parser = build_parser()
    args = parser.parse_args(argv)
    manual = (args.coordinator, args.num_processes, args.process_id)
    if args.multihost or any(v is not None for v in manual):
        if any(v is not None for v in manual) and None in manual:
            parser.error("--coordinator, --num-processes and --process-id "
                         "must be given together for a manual slice")
        from ..parallel.mesh import ENV_VARS, multihost_mesh

        missing = [v for v in ENV_VARS if v not in os.environ]
        if args.coordinator is None and missing:
            parser.error(f"--multihost joins through env:// and needs "
                         f"{', '.join(missing)}; or pass --coordinator, "
                         "--num-processes and --process-id")
        # Before any engine work; a rendezvous that gets no answer within
        # the slice timeout raises (there is no single-process fallback).
        multihost_mesh(coordinator=args.coordinator,
                       num_processes=args.num_processes,
                       process_id=args.process_id, auto_init=True,
                       device=args.device)
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
        unit_queue=args.unit_queue,
        fuse_max_units=args.fuse_max_units,
        device_streams=args.device_streams,
        max_tries=args.max_tries,
        backoff=args.backoff,
        retry_cap=args.retry_cap,
        outbox_dir=args.outbox_dir,
        prefetch_units=args.prefetch_units,
        rule_workers=args.rule_workers,
        pmk_cache_dir=args.pmk_cache_dir,
        pmk_cache_max_bytes=args.pmk_cache_max_bytes,
        dict_cache_dir=args.dict_cache_dir,
        dict_cache_max_bytes=args.dict_cache_max_bytes,
        device=args.device,
    )
    TpuCrackClient(cfg).run()
    from ..parallel.mesh import leave_slice

    leave_slice()


if __name__ == "__main__":
    main()
