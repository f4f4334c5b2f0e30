"""One module per kind of traffic (`traffic/<mix>.json`'s "kind"): its
`Job` sets a cell up, runs one unit of the window at a time, reports the
end-to-end values and checks what the window produced."""
