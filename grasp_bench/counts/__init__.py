"""One file per port kernel (named as the program's launcher names it):
`NAMES`, substrings of its device kernels' names in a profiler trace, and
`work(args, cfg)`, the operations and bytes the launch's data needs,
computed from the arguments the launch was given (`cfg`: the cell's model
configuration)."""
