"""One file per entry of the program's `cuda_build.launch`, named by the
entry: `cost(args)` gives the least time the card could take for one
launch with those arguments (`roofline.least_s` of the bytes each input
is read and each output written once, and the operations the entry's
plain version does), counted from the launch's own shapes."""
