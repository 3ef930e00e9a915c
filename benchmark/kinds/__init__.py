"""One module an input kind, found by the `kind` that a traffic file
(`benchmark/traffic/<mix>.json`) names: `kinds/<kind>.py`.

A kind holds everything a mix of its inputs needs, so that a new kind is
a new file and a new mix of a kind is a data file alone:

  ENTRIES         {name: "module:attribute"}: the program's entry points
                  and configs the kind's calls go through
  Loop(traffic, config, entries, device, seed)
                  .setup()      the inputs, made on the device from the seed
                  .step(i)      call i through the entries -> its outputs
                  .work(out)    (frames, pairs) a call's outputs hold
                  .check(kept, precision)
                                the numbers compared with the limits: the
                                kept calls' outputs against the plain
                                reference's, worked out again from the
                                same inputs
                  .batch        frames a call extracts (0: none)
  control(precision)
                  the reference with the ENTRIES' names, computed in the
                  precisions given: the control of `correct`

Call i always does the same work for a seed: its inputs are fixed by i.
"""
