#!/bin/bash
# Golden end-to-end test harness, mirroring the reference CI gate
# (test-dir/run_test.sh): run the full pipeline on the bundled test data and
# require the genotype-concordance evaluation to diff-equal the golden .eval.
set -u

TESTDIR="${SVJT_TESTDIR:-/root/reference/test-dir}"
REPO="$(cd "$(dirname "$0")" && pwd)"
WORK="$(mktemp -d)"
trap 'rm -rf "$WORK"' EXIT

if [ ! -d "$TESTDIR" ]; then
    echo "test data not found at $TESTDIR"
    exit 1
fi

cd "$WORK"
# Correctness gate: run on the CPU (SVJT_PLATFORM=cuda runs it on the GPU).
export JAX_PLATFORMS="${SVJT_PLATFORM:-cpu}"
PYTHONPATH="$REPO" python3 -m svjedi_tpu run \
    -v "$TESTDIR/test.vcf" \
    -r "$TESTDIR/reference_genome.fasta" \
    -q "$TESTDIR/simulated_reads.fastq.gz" \
    -p test -t 1 1>/dev/null 2>&1

PYTHONPATH="$REPO" python3 -m svjedi_tpu eval \
    "$TESTDIR/test.vcf" test_genotype.vcf > test_genotype.vcf.eval

if diff -q test_genotype.vcf.eval "$TESTDIR/expected_genotype.vcf.eval" \
    1>/dev/null 2>&1; then
    echo "svjedi-tpu test : PASS"
    echo "-----------------"
    echo "Details:"
    if diff --ignore-matching-lines="^#" test_genotype.vcf \
        "$TESTDIR/expected_genotype.vcf" 1>/dev/null 2>&1; then
        echo "VCF lines are identical"
    else
        NDIFF=$(diff --ignore-matching-lines="^#" test_genotype.vcf \
            "$TESTDIR/expected_genotype.vcf" 2>/dev/null \
            | grep -c '^<' || true)
        echo "Genotypes are correct but VCF lines differ" \
            "($NDIFF records, DP/AD count deltas; see PARITY.md +" \
            "PARITY_DELTAS.tsv)"
    fi
    exit 0
else
    echo "svjedi-tpu test : FAILED"
    cat test_genotype.vcf.eval
    exit 1
fi
