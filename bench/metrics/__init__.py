"""One reader per metric: ``<name>.py`` with ``read(rec)``, which returns
None where the run holds nothing for it to read.  A split name
``<base>.<part>`` (the same quantity in cells that report different
end-to-end metrics) is read by ``<base>.py`` unless it has a file of its
own."""
