import time

T_START = time.perf_counter()   # set-up is timed from here, before any import

if __name__ == "__main__":
    import sys

    from port_bench.run import main

    sys.exit(main(t_start=T_START))
