#!/bin/bash
# Eval driver of the PyTorch/CUDA port, the reference's contract:
#   ./tpudenoise_torch/experiments/scripts/test_faster_rcnn.sh DEVICE DATASET NET NOISE [extra --set args]
# (ref experiments/scripts/test_faster_rcnn.sh:8-16), run from the
# repository root: it tests the snapshot train_faster_rcnn.sh writes
# (output/${NET}/${TRAIN_IMDB}/${TAG}/${NET}_faster_rcnn_iter_${ITERS}.pt)
# with experiments/cfgs/${NET}.yml. DEVICE selects the GPU
# (CUDA_VISIBLE_DEVICES).

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
    ITERS=70000
    ANCHORS="[8,16,32]"
    RATIOS="[0.5,1,2]"
    ;;
  pascal_voc_0712)
    TRAIN_IMDB="voc_2007_trainval+voc_2012_trainval"
    TEST_IMDB="voc_2007_test"
    ITERS=110000
    ANCHORS="[8,16,32]"
    RATIOS="[0.5,1,2]"
    ;;
  coco)
    TRAIN_IMDB="coco_2014_train+coco_2014_valminusminival"
    TEST_IMDB="coco_2014_minival"
    ITERS=490000
    ANCHORS="[4,8,16,32]"
    RATIOS="[0.5,1,2]"
    ;;
  rrData)
    TRAIN_IMDB="rrData_2021_train"
    TEST_IMDB="rrData_2021_test"
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
LOG="experiments/logs/test_${NET}_${TEST_IMDB}_${NOISE}_${EXTRA_ARGS_SLUG}.txt.`date +'%Y-%m-%d_%H-%M-%S'`"
exec &> >(tee -a "$LOG")
echo Logging output to "$LOG"

TAG=${EXTRA_ARGS_SLUG:-default}
MODEL=output/${NET}/${TRAIN_IMDB}/${TAG}/${NET}_faster_rcnn_iter_${ITERS}

CUDA_VISIBLE_DEVICES=${DEVICE_ID} python -m tpudenoise_torch.cli.test \
  --model ${MODEL} \
  --imdb ${TEST_IMDB} \
  --cfg experiments/cfgs/${NET}.yml \
  --net ${NET} \
  --tag ${TAG} \
  --noise ${NOISE} \
  --set ANCHOR_SCALES ${ANCHORS} ANCHOR_RATIOS ${RATIOS} ${EXTRA_ARGS}
