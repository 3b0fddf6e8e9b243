#!/bin/bash
# Train driver of the PyTorch/CUDA port, the reference's contract:
#   ./tpudenoise_torch/experiments/scripts/train_faster_rcnn.sh DEVICE DATASET NET NOISE [extra --set args]
# (ref experiments/scripts/train_faster_rcnn.sh:8-16), run from the
# repository root: it reads experiments/cfgs/${NET}.yml and writes
# experiments/logs/ and output/ under the working directory. DEVICE
# selects the GPU (CUDA_VISIBLE_DEVICES). Training is skipped when the
# final snapshot (NET_FINAL) exists.

set -x
set -e

export PYTHONUNBUFFERED="True"

DEVICE_ID=$1
DATASET=$2
NET=$3
NOISE=$4

array=( $@ )
len=${#array[@]}
EXTRA_ARGS=${array[@]:4:$len}
EXTRA_ARGS_SLUG=${EXTRA_ARGS// /_}

case ${DATASET} in
  pascal_voc)
    TRAIN_IMDB="voc_2007_trainval"
    TEST_IMDB="voc_2007_test"
    STEPSIZE="[50000]"
    ITERS=70000
    ANCHORS="[8,16,32]"
    RATIOS="[0.5,1,2]"
    ;;
  pascal_voc_0712)
    TRAIN_IMDB="voc_2007_trainval+voc_2012_trainval"
    TEST_IMDB="voc_2007_test"
    STEPSIZE="[80000]"
    ITERS=110000
    ANCHORS="[8,16,32]"
    RATIOS="[0.5,1,2]"
    ;;
  coco)
    TRAIN_IMDB="coco_2014_train+coco_2014_valminusminival"
    TEST_IMDB="coco_2014_minival"
    STEPSIZE="[350000]"
    ITERS=490000
    ANCHORS="[4,8,16,32]"
    RATIOS="[0.5,1,2]"
    ;;
  rrData)
    TRAIN_IMDB="rrData_2021_train"
    TEST_IMDB="rrData_2021_val"
    STEPSIZE="[50000]"
    ITERS=5000
    ANCHORS="[8,16,32]"
    RATIOS="[0.5,1,2]"
    ;;
  *)
    echo "No dataset given"
    exit 1
    ;;
esac

mkdir -p experiments/logs
LOG="experiments/logs/${NET}_${TRAIN_IMDB}_${NOISE}_${EXTRA_ARGS_SLUG}.txt.`date +'%Y-%m-%d_%H-%M-%S'`"
exec &> >(tee -a "$LOG")
echo Logging output to "$LOG"

TAG=${EXTRA_ARGS_SLUG:-default}
NET_FINAL=output/${NET}/${TRAIN_IMDB}/${TAG}/${NET}_faster_rcnn_iter_${ITERS}.pkl

if [ ! -f "${NET_FINAL}" ]; then
  CUDA_VISIBLE_DEVICES=${DEVICE_ID} python -m tpudenoise_torch.cli.trainval \
    ${WEIGHT:+--weight ${WEIGHT}} \
    --imdb ${TRAIN_IMDB} \
    --imdbval ${TEST_IMDB} \
    --iters ${ITERS} \
    --cfg experiments/cfgs/${NET}.yml \
    --tag ${TAG} \
    --net ${NET} \
    --noise ${NOISE} \
    --set ANCHOR_SCALES ${ANCHORS} ANCHOR_RATIOS ${RATIOS} \
    TRAIN.STEPSIZE ${STEPSIZE} ${EXTRA_ARGS}
fi
