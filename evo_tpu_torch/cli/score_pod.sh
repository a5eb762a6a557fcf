#!/bin/bash
# Multi-node FASTA scoring launcher for the PyTorch port: the twin of
# scripts/score_pod.sh, with torchrun over the nodes of a GPU cluster in
# the place of gcloud over the workers of a TPU slice.
#
# Starts the same command on every node: torchrun with this node's rank
# and the first node as the rendezvous, one process a card, running
# `python -m evo_tpu_torch.cli.score`. Its sharded, restartable output
# does the rest: each model replica scores its shards of the FASTA into
# `<output-tsv>.work/` (a manifest, a CSV and a done-marker a shard, so a
# re-run resumes) and rank 0 writes the merged TSV in input order.
#
# Usage (from a machine that reaches every node by ssh, in a checkout
# that lies at the same path on each of them):
#   NODES="gpu-0 gpu-1" GPUS_PER_NODE=8 TP=2 \
#     evo_tpu_torch/cli/score_pod.sh genomes.fasta out.tsv \
#     evo-1-131k-base /ckpt/path
#
# TP: tensor-parallel ranks of a replica (within a node); without it (1)
# every rank is a replica. DRY_RUN=1 prints each node's command instead
# of starting it. LAUNCH (default ssh) is the remote shell; under Slurm,
# submit the printed command per node with srun instead.

set -euo pipefail

INPUT_FASTA=${1:?input fasta}
OUTPUT_TSV=${2:?output tsv}
MODEL_NAME=${3:-evo-1-8k-base}
CKPT=${4:?checkpoint path (read by every node)}
NODES=${NODES:?space-separated node names; the first is the rendezvous}
GPUS_PER_NODE=${GPUS_PER_NODE:-8}
TP=${TP:-1}
MASTER_PORT=${MASTER_PORT:-29500}
LAUNCH=${LAUNCH:-ssh}
DRY_RUN=${DRY_RUN:-0}

read -r -a HOSTS <<< "${NODES}"
N_NODES=${#HOSTS[@]}
MASTER=${HOSTS[0]}
TP_FLAG=""
if [ "${TP}" -gt 1 ]; then
  TP_FLAG="--tp ${TP}"
fi

PIDS=()
for NODE_RANK in "${!HOSTS[@]}"; do
  HOST=${HOSTS[${NODE_RANK}]}
  CMD="cd $(pwd) && torchrun --nnodes ${N_NODES} --node-rank ${NODE_RANK} \
--nproc-per-node ${GPUS_PER_NODE} --master-addr ${MASTER} \
--master-port ${MASTER_PORT} -m evo_tpu_torch.cli.score \
--input-fasta ${INPUT_FASTA} --output-tsv ${OUTPUT_TSV} \
--model-name ${MODEL_NAME} --checkpoint-path ${CKPT} --dp -1 ${TP_FLAG}"
  if [ "${DRY_RUN}" = "1" ]; then
    echo "${HOST}: ${CMD}"
  else
    ${LAUNCH} "${HOST}" "${CMD}" &
    PIDS+=($!)
  fi
done
for PID in "${PIDS[@]+"${PIDS[@]}"}"; do
  wait "${PID}"
done
