"""Count one (arch x shape) cell of the PyTorch package on the 256- or
512-rank production mesh and print its memory and H100 roofline terms: the
twin of pod_dryrun_roofline.py, from `repro_torch.launch.dryrun.run_cell`.
Runs on the CPU with nothing allocated (a fake process group, meta
tensors); no card is needed.

    PYTHONPATH=src python examples/pod_dryrun_roofline_torch.py --arch yi-34b \\
        --shape decode_32k [--multi-pod]
"""
import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args()

    import pathlib

    from repro_torch.launch.dryrun import run_cell

    rec = run_cell(args.arch, args.shape, args.multi_pod, pathlib.Path(args.out), force=True)
    if rec["status"] != "ok":
        print(rec)
        return
    r = rec["roofline"]
    print(f"cell          : {rec['cell']}")
    print(f"chips         : {rec['chips']}")
    print(f"bytes/device  : {rec['bytes_per_device']/2**30:.2f} GiB")
    print(f"t_compute     : {r['t_compute']:.3e} s")
    print(f"t_memory      : {r['t_memory']:.3e} s")
    print(f"t_collective  : {r['t_collective']:.3e} s")
    print(f"bottleneck    : {r['bottleneck']}")
    print(f"useful flops  : {100*r['useful_flops_ratio']:.1f}% of counted dot flops")
    print(f"roofline frac : {100*r['roofline_fraction']:.1f}%")
    print(f"collectives   : {r['collectives']}")
    print(f"wire/chip     : {r['logical_wire_bytes_per_chip']/2**30:.2f} GiB logical, "
          f"{r['wire_bytes_per_chip']/2**30:.2f} GiB sent (all-reduces)")


if __name__ == "__main__":
    main()
