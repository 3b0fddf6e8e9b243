"""Weight conversion CLI (counterpart of `tpudenoise/cli/convert.py`),
its torchvision path: a torchvision resnet50/101/152 `.pth` or `.pt`
becomes a `.npz` in the shared layout, which `cli.test --model`,
`cli.trainval --weight` and the JAX package all read.

    python -m tpudenoise_torch.cli.convert --src resnet101.pth \\
        --net res101 --out res101_imagenet.npz

The same flags as the JAX CLI.  The source goes through
`models.convert.convert_torch_resnet` (numpy only: conv1 flipped to BGR,
kernels to HWIO, BN statistics by name).  The file is read with
`torch.load(..., map_location='cpu', weights_only=False)`: the JAX CLI
takes a pickled module (anything with `.state_dict()`) as well as a bare
state dict, and only the full unpickler restores a module.  That runs
code from the file, so convert only files you trust; torchvision's
published `.pth` files are bare state dicts.

Refused, by name: `--detector`, and any source that is not a `.pth` or
`.pt` (vgg16, mobile and resnet tf-slim checkpoints).  Those read
TensorFlow checkpoints, and the GPU machine has no TensorFlow: run
`python -m tpudenoise.cli.convert` with the same flags on a host that has
it, and give the port the `.npz` it writes.  A `.pth` for a net that is
not a resnet is refused as the JAX CLI's assertion refuses it.  The CLI
does no device work, so it has no `--device`.
"""

from __future__ import annotations

import argparse

from tpudenoise_torch.cli.test import NETS


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Convert pretrained weights '
                                            'to the shared .npz layout')
    p.add_argument('--src', required=True,
                   help='torchvision resnet .pth/.pt file (tf-slim '
                        'checkpoints: python -m tpudenoise.cli.convert)')
    p.add_argument('--net', required=True, choices=NETS)
    p.add_argument('--out', required=True, help='output .npz path')
    p.add_argument('--detector', action='store_true',
                   help='a reference-trained Faster R-CNN checkpoint '
                        '(TensorFlow: refused here)')
    return p.parse_args(argv)


def _tensorflow_needed(what: str) -> NotImplementedError:
    return NotImplementedError(
        f'{what} reads a TensorFlow checkpoint, and the port runs without '
        f'TensorFlow: run `python -m tpudenoise.cli.convert` with the same '
        f'flags on a host that has TensorFlow; the port reads the .npz it '
        f'writes.')


def refuse_unported(args):
    """Raise for the sources only the JAX CLI can read."""
    if args.detector:
        raise _tensorflow_needed('--detector (a reference-trained detector)')
    if not args.src.endswith(('.pth', '.pt')):
        raise _tensorflow_needed(f'--net {args.net} from {args.src!r} (not a '
                                 f'.pth/.pt: a tf-slim checkpoint)')
    if not args.net.startswith('res'):
        raise ValueError(f'--net {args.net} from a .pth: the torch '
                         f'conversion is implemented for resnets (res50, '
                         f'res101, res152) only')


def main(argv=None):
    """Converts; returns the written tree."""
    args = parse_args(argv)
    refuse_unported(args)
    import torch
    from tpudenoise_torch.models.convert import (convert_torch_resnet,
                                                 save_tree_npz)
    sd = torch.load(args.src, map_location='cpu', weights_only=False)
    if hasattr(sd, 'state_dict'):
        sd = sd.state_dict()
    sd = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    tree = convert_torch_resnet(sd, int(args.net[3:]))
    save_tree_npz(tree, args.out)
    print(f'wrote {args.out}')
    return tree


if __name__ == '__main__':
    main()
