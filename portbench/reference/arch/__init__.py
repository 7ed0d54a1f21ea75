"""One module per architecture, ``<architecture>.py``, named by the
``architecture`` key of a configuration file and loaded by path from the
checkout (:func:`portbench.reference.weights.architecture`). A later
architecture is one new file here; no other file of the benchmark changes.
A module imports only ``torch`` and ``portbench.reference``, and holds:

* ``sizes(conf)``: the sizes the reference reads, from the configuration
  file's JSON; ``layers`` (a multiple of the period's length), ``d``,
  ``vocab`` and ``eps`` among them.
* ``period(sz)``: the parameters of one period, one list per sub-layer
  ``j`` of ``(name, shape, init, scale)``: its leaves under
  ``blocks/sub<j>/``, shapes without the leading axis over the periods.
  ``init`` is ``normal`` (times ``scale``), ``ones``, ``zeros`` or a key of
  ``INITS``.
* ``INITS``: ``{init: draw(shape, sz, gen, device)}``, each further
  initialiser, drawn in float32 from the generator ``gen``.
* ``blocks(sz)``: the block function of each sub-layer of a period,
  ``block(x, p, sz, prec)`` for activations ``x`` (B, S, d) in float32, the
  sub-layer's float32 weights ``p`` by name, and a
  :class:`portbench.reference.lm.Precision`; it returns the residual stream.
* ``matmul_params(sz)``: the parameters of every period that take part in
  matrix products, a token's active ones (an MoE's routed experts times
  the experts a token takes); the yardstick adds the head.
* ``mixer_flops_forward(sz, seq_len)``: forward FLOPs of one sequence's
  token mixing, beyond the weights, over every period.
* ``port_fields(sz)``: plain values for ``dataclasses.replace`` of the
  port's ``ArchConfig`` beyond the layers, width, vocabulary and norm's
  epsilon, with ``period`` as ``(mixer, mlp)`` pairs of strings.
* ``state_reset(sz)``: the chunk length at whose boundaries the fault of a
  scan whose state does not cross between chunks drops it, or None where
  no sub-layer scans.
"""
