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
# The scale records (SCENE, GIGA, CHANGESTREAM, MULTIHOST, ARCH_SPEEDUP,
# STREAMASM, MULTIINDEX) come last; the merged ones (GIGA, MULTIHOST, STREAMASM) add an
# entry per run, so remove the old file before remaking one.
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
# job dirs in RAM: the benches write many small tiles; each bench's log
# goes to LT_RECORD_LOGS (default: a fresh temporary directory)
export TMPDIR=/dev/shm/lt_records_$$
mkdir -p "$TMPDIR"
LOGS=${LT_RECORD_LOGS:-$(mktemp -d)}
mkdir -p "$LOGS"

run() {
    name=$1
    shift
    case " ${ONLY:-$name} " in *" $name "*) ;; *) return ;; esac
    start=$(date +%s)
    python3 -m "land_trendr_tpu_torch.tools.$name" "$@" >> "$LOGS/$name.log" 2>&1
    rc=$?
    echo "$name rc=$rc $(( $(date +%s) - start ))s"
    if [ $rc -ne 0 ]; then tail -40 "$LOGS/$name.log"; fi
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

# the scale records, at the JAX records' sizes; their work dirs on disk
# (.scale_records under the repo root): a 5000²
# stack, a 40000² mosaic and a 16000² product set do not fit in RAM.  The
# card machine's disk takes ~45 GiB of writes a call, so make SCENE and
# STREAMASM (which re-assembles SCENE's workdir) in one call and the other
# four and the multi-index run (a 1024² stack) in another: BENCH names
# `run_segment_measured stream_assembly_bench`, then `giga_run
# change_stream_bench multihost_bench arch_speedup multiindex_bench`.
SCALE=.scale_records
mkdir -p "$SCALE"
unset TMPDIR
df -h "$SCALE" | tail -1
case " ${ONLY:-run_segment_measured} " in *" run_segment_measured "*)
    start=$(date +%s)
    python3 -m land_trendr_tpu_torch synth "$SCALE/scene_stack" --size 5000 > /dev/null
    echo "synth 5000 rc=$? $(( $(date +%s) - start ))s" ;;
esac
run run_segment_measured --out "$OUT/SCENE_h100.json" segment "$SCALE/scene_stack" \
    --workdir "$SCALE/scene_work" --out-dir "$SCALE/scene_out" --tile-size 512
rm -rf "$SCALE/scene_out"
run giga_run all --size 4096 --out-root "$SCALE/giga" --out "$OUT/GIGA_h100.json"
rm -rf "$SCALE/giga"
run giga_run all --size 16384 --out-root "$SCALE/giga" --out "$OUT/GIGA_h100.json"
rm -rf "$SCALE/giga"
run change_stream_bench --size=16000 --mmu=9 --work-root "$SCALE" \
    --out "$OUT/CHANGESTREAM_h100.json"
run multihost_bench --size 512 --tile 128 --workroot "$SCALE/pod" --out "$OUT/MULTIHOST_h100.json"
run multihost_bench --size 2048 --tile 512 --year-start 1984 --year-end 2023 \
    --workroot "$SCALE/pod" --out "$OUT/MULTIHOST_h100.json"
run arch_speedup 2048 65536 --card-px 65536,262144 --out "$OUT/ARCH_SPEEDUP_h100.json"
run stream_assembly_bench scene "$SCALE/scene_work" --stack-dir "$SCALE/scene_stack" \
    --tile-size 512 --out "$OUT/STREAMASM_h100.json"
run stream_assembly_bench mosaic --size=40000 --work-root "$SCALE" \
    --out "$OUT/STREAMASM_h100.json"
run multiindex_bench --work-root "$SCALE/multiindex" --out "$OUT/MULTIINDEX_h100.json"
rm -rf "$SCALE"
