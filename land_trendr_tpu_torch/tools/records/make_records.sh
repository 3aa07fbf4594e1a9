#!/bin/sh
# Make the card's records of record: every port bench at its full size on
# the card (an H100), each report carrying its command, commit (null where
# the checkout has no .git), the digest of the package sources it ran
# (`source_sha256`, tools/measure.py:source_digest) and the card's
# nvidia-smi name and power limit.  The perf gate's bands derive from
# these files.
#
#   sh land_trendr_tpu_torch/tools/records/make_records.sh [OUT_DIR [BENCH ...]]
#
# (default OUT_DIR: this directory; BENCH names, e.g. `fetch_bench`, pick
# which records to remake, default all).  Run from the repo root.  Each
# bench's exit code is printed; a failed bench does not stop the others.
# The timed ratios that sit under the gate's speedup floor on the card
# (packed fetch and upload, the batched flood) are taken over several
# reps, every rep kept in the record.  The full capacity_bench takes about
# half an hour and runs last.
OUT=${1:-land_trendr_tpu_torch/tools/records}
[ $# -gt 0 ] && shift
ONLY="$*"
mkdir -p "$OUT"
# the host raster codec (the feed and write paths use it when built), then
# both kernel libraries before any replica process starts
LT_NATIVE_LIB=$(python3 -c "import chip_smoke; print(chip_smoke.build_native() or '')")
export LT_NATIVE_LIB
python3 -c "from land_trendr_tpu_torch.ops import segment_cuda; print(segment_cuda.build_info()['path'])"
# job dirs in RAM: the benches write many small tiles
export TMPDIR=/dev/shm/lt_records_$$
mkdir -p "$TMPDIR"

run() {
    name=$1
    shift
    case " ${ONLY:-$name} " in *" $name "*) ;; *) return ;; esac
    start=$(date +%s)
    python3 -m "land_trendr_tpu_torch.tools.$name" "$@" > "$TMPDIR/$name.log" 2>&1
    rc=$?
    echo "$name rc=$rc $(( $(date +%s) - start ))s"
    if [ $rc -ne 0 ]; then tail -40 "$TMPDIR/$name.log"; fi
}

run parity_paramspace 256 "$OUT/PARITY_PARAMS_h100.json" --seed-base 1000,2000
run feed_bench --out "$OUT/FEED_h100.json"
run fetch_bench --reps 15 --out "$OUT/FETCH_h100.json"
run upload_bench --reps 15 --out "$OUT/UPLOAD_h100.json"
run host_path_bench --out "$OUT/HOSTPATH_h100.json"
run serve_bench --out "$OUT/SERVE_h100.json"
run flight_overhead --out "$OUT/FLIGHT_h100.json"
run batch_bench --reps 5 --out "$OUT/BATCH_h100.json"
run tune_bench --out "$OUT/TUNE_h100.json"
run reqtrace_bench --out "$OUT/REQTRACE_h100.json"
run capacity_bench --out "$OUT/CAPACITY_h100.json"
rm -rf "$TMPDIR"
