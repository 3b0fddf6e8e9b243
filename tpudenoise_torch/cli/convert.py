"""Weight conversion CLI (counterpart of `tpudenoise/cli/convert.py`): a
tf-slim ImageNet checkpoint, a reference-trained Faster R-CNN checkpoint
or a torchvision resnet becomes a `.npz` in the shared layout, which
`cli.test --model`, `cli.trainval --weight` and the JAX package all
read.  No TensorFlow is needed: checkpoints are read with numpy
(`models/tf_checkpoint.py`).

    python -m tpudenoise_torch.cli.convert --src vgg_16.ckpt \\
        --net vgg16 --out vgg16_imagenet.npz
    python -m tpudenoise_torch.cli.convert --src resnet_v1_101.ckpt \\
        --net res101 --out res101_imagenet.npz
    python -m tpudenoise_torch.cli.convert --src mobilenet_v1_1.0_224.ckpt \\
        --net mobile --out mobile_imagenet.npz
    python -m tpudenoise_torch.cli.convert \\
        --src res101_faster_rcnn_iter_5000.ckpt --net res101 --detector \\
        --out ref_detector.npz
    python -m tpudenoise_torch.cli.convert --src resnet101.pth \\
        --net res101 --out res101_imagenet.npz

The same flags and routes as the JAX CLI.  `--src` is a checkpoint
prefix (V2: `prefix.index` and its data files; V1: the file itself) or
a `.pth`/`.pt`.  `--detector` goes to `convert_ref_detector` (the full
{head, rpn, tail} tree, no surgery); a `.pth`/`.pt` to
`convert_torch_resnet`; anything else to the tf-slim converter of
`--net` (conv1 flipped to BGR; vgg16's fc6/fc7 made dense; mobilenet's
Conv2d_0 also divided by 255 / 2).  A `.pth` for a net that is not a
resnet is refused, as the JAX CLI's assertion refuses it.  A `.pth` is
read with `torch.load(..., map_location='cpu', weights_only=False)`:
the JAX CLI takes a pickled module (anything with `.state_dict()`) as
well as a bare state dict, and only the full unpickler restores a
module.  That runs code from the file, so convert only files you trust;
torchvision's published `.pth` files are bare state dicts.  The CLI does
no device work, so it has no `--device`.
"""

from __future__ import annotations

import argparse

from tpudenoise_torch.cli.test import NETS


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Convert pretrained weights '
                                            'to the shared .npz layout')
    p.add_argument('--src', required=True,
                   help='tf-slim or trained-detector checkpoint prefix, '
                        'or a torchvision resnet .pth/.pt file')
    p.add_argument('--net', required=True, choices=NETS)
    p.add_argument('--out', required=True, help='output .npz path')
    p.add_argument('--detector', action='store_true',
                   help='source is a reference-trained Faster R-CNN '
                        'checkpoint (full tree incl. rpn + cls/bbox '
                        'heads), not an ImageNet backbone')
    return p.parse_args(argv)


def _torch_source(src: str) -> bool:
    return src.endswith(('.pth', '.pt'))


def refuse_unported(args):
    """Raise for what the JAX CLI refuses: a `.pth` for a net that is not
    a resnet."""
    if (not args.detector and _torch_source(args.src)
            and not args.net.startswith('res')):
        raise ValueError(f'--net {args.net} from a .pth: the torch '
                         f'conversion is implemented for resnets (res50, '
                         f'res101, res152) only')


def convert(args) -> dict:
    """The JAX-layout tree of args' source."""
    from tpudenoise_torch.models import convert as C
    if args.detector:
        return C.convert_ref_detector(args.src, args.net)
    if _torch_source(args.src):
        import torch
        sd = torch.load(args.src, map_location='cpu', weights_only=False)
        if hasattr(sd, 'state_dict'):
            sd = sd.state_dict()
        sd = {k: v.detach().cpu().numpy() for k, v in sd.items()}
        return C.convert_torch_resnet(sd, int(args.net[3:]))
    if args.net == 'vgg16':
        return C.convert_tf_slim_vgg16(args.src)
    if args.net == 'mobile':
        return C.convert_tf_slim_mobilenet(args.src)
    return C.convert_tf_slim_resnet(args.src, int(args.net[3:]))


def main(argv=None):
    """Converts; returns the written tree."""
    args = parse_args(argv)
    refuse_unported(args)
    from tpudenoise_torch.models.convert import save_tree_npz
    tree = convert(args)
    save_tree_npz(tree, args.out)
    print(f'wrote {args.out}')
    return tree


if __name__ == '__main__':
    main()
