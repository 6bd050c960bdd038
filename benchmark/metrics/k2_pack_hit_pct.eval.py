"""Share of K2's preparations that packed no weights: of the program's
outermost `k2.pack` spans (kernels/conv_stack.py:_prepared) in the traced
slice, those with no `k2.pack.weights` child (the packing itself, absent
where the wrapper's cache of packed weights served), in %. None without a
`sweep` or a `k2.pack` span, and for a program without that cache
(no `conv_stack_bf16.pack_hits`), which records no `k2.pack.weights`."""
from benchmark.metrics._program import batches, outermost, spans


def read(run):
    from turboae_tpu_torch.kernels import conv_stack
    if not hasattr(conv_stack.conv_stack_bf16, 'pack_hits'):
        return None
    sp = spans(run)
    if not batches(sp):
        return None
    outer = {id(s) for s in outermost(sp, 'k2.pack')}
    packs = [i for i, s in enumerate(sp) if id(s) in outer]
    if not packs:
        return None
    packed = {s[3] for s in sp if s[0] == 'k2.pack.weights'}
    return 100.0 * sum(i not in packed for i in packs) / len(packs)
