"""Quickstart: a tour of the Lustre storage architecture.

Builds a 4-OST / 2-MDS cluster in-process, then walks through the paper's
headline features: striped files, intent-based metadata (1 RPC), the DLM,
unlink with llog-cookied object destruction, clustered metadata, failover,
and the collaborative read cache.  The port of `examples/quickstart.py`:
it prints the same lines.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from repro_torch.core import LustreCluster
from repro_torch.core import cobd as cobd_mod
from repro_torch.examples import arg_parser
from repro_torch.fsio import LustreClient


def main(argv=None):
    args = arg_parser(__doc__).parse_args(argv)
    cluster = LustreCluster(osts=4, mdses=2, clients=3,
                            ost_failover=True, commit_interval=32,
                            device=args.device)
    fs = LustreClient(cluster).mount()
    print("== cluster: 4 OSTs (failover ring), 2 MDSes, 3 client nodes ==")

    # --- striping (ch. 10): a file striped over all 4 OSTs
    fs.mkdir_p("/proj/run1")
    fh = fs.creat("/proj/run1/data.bin", stripe_count=4, stripe_size=4096)
    payload = bytes(range(256)) * 256                     # 64 KiB
    fs.write(fh, payload)
    fs.close(fh)
    st = fs.stat("/proj/run1/data.bin")
    print(f"striped file: size={st['size']} stripes={st['stripe_count']}")

    # --- intent metadata (ch. 7.5): lookups are ONE rpc, then cached
    c0 = cluster.stats.counters.get("rpc.mds.ldlm_enqueue", 0)
    fs.stat("/proj/run1/data.bin")
    fs.stat("/proj/run1/data.bin")                        # dcache hit
    c1 = cluster.stats.counters.get("rpc.mds.ldlm_enqueue", 0)
    print(f"2 stats cost {c1 - c0} lock-intent RPCs "
          f"(dcache hits: {cluster.stats.counters.get('fs.dcache_hit', 0)})")

    # --- OST failover (ch. 11): kill ost0; reads fail over to the standby
    cluster.ost_targets[0].commit()
    cluster.lctl("fail", "ost0")
    fh = fs.open("/proj/run1/data.bin")
    assert fs.read(fh, 65536) == payload
    fs.close(fh)
    print("ost0 killed -> reads served via failover ring:",
          fs.lov.oscs[0].imp.active_nid)
    cluster.lctl("restart", "ost0")

    # --- collaborative cache (ch. 5.5): reads referred to a peer cache
    cobd_mod.make_caching_node(cluster, "client1", cluster.ost_targets[1],
                               "COBD-demo")
    reader = LustreClient(cluster, 2).mount()
    fh = reader.open("/proj/run1/data.bin")
    reader.read(fh, 65536)
    reader.close(fh)
    print("collaborative cache served",
          cluster.stats.bytes.get("cobd.served", 0), "bytes "
          f"(referrals: {cluster.stats.counters.get('ost.referral', 0)})")

    # --- unlink (ch. 8.4): EA+cookies back to client, objects destroyed
    objs = fs.statfs()["objects"]
    fs.unlink("/proj/run1/data.bin")
    print(f"unlink destroyed {objs - fs.statfs()['objects']} stripe objects "
          "(llog-cookied)")

    print(f"\nvirtual time elapsed: {cluster.now * 1e3:.2f} ms")
    print("RPC counters:", {k: v for k, v in sorted(
        cluster.stats.counters.items()) if k.startswith("rpc.")})


if __name__ == "__main__":
    main()
