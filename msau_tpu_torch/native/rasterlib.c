/* rasterlib — native host core for chargrid box-program generation.
 *
 * The reference outsources its data loader's hot loop to Python
 * (per-character numpy slice assignment, data_generator_funsd.py:347-387).
 * Here the per-character geometry runs as a tight C loop; Python assembles
 * the resulting flat record table into paint programs with numpy.
 *
 * Build: python msau_tpu/native/build.py   (gcc -O2 -shared -fPIC)
 * ABI: plain C, consumed via ctypes (msau_tpu/native/__init__.py).
 */

#include <stdint.h>

/* Per-character box records for a batch of scaled text lines.
 *
 * line_boxes: [n_lines * 4] int32 (x1, y1, x2, y2), already scaled/offset.
 * text_offsets: [n_lines + 1] int32 — char_ids[text_offsets[i]:text_offsets[i+1]]
 *   are line i's token ids.
 * char_w_cap_factor: cap char width at (int)((y2 - y1) * factor).
 * out_records: [total_chars * 5] int32 — (y1, y2, start_x, end_x, char_id).
 * out_line_idx / out_char_pos: [total_chars] int32 — 1-based line id and
 *   char position (for the KV line-id / char-id planes).
 *
 * Returns the number of records written (== total chars of non-empty lines).
 */
int64_t build_char_records(
    int64_t n_lines,
    const int32_t* line_boxes,
    const int32_t* text_offsets,
    const int32_t* char_ids,
    double char_w_cap_factor,
    int32_t* out_records,
    int32_t* out_line_idx,
    int32_t* out_char_pos)
{
    int64_t n_out = 0;
    for (int64_t li = 0; li < n_lines; ++li) {
        const int32_t x1 = line_boxes[li * 4 + 0];
        const int32_t y1 = line_boxes[li * 4 + 1];
        const int32_t x2 = line_boxes[li * 4 + 2];
        const int32_t y2 = line_boxes[li * 4 + 3];
        const int32_t t0 = text_offsets[li];
        const int32_t t1 = text_offsets[li + 1];
        const int32_t len = t1 - t0;
        if (len <= 0) continue;

        double char_full_w = (double)(x2 - x1) / (double)len;
        if (char_full_w < 1.0) char_full_w = 1.0;
        double char_w = 0.9 * char_full_w;
        if (char_w < 1.0) char_w = 1.0;
        double cap = (double)((int64_t)((y2 - y1) * char_w_cap_factor));
        if (char_w > cap) char_w = cap;

        for (int32_t j = 0; j < len; ++j) {
            double offset = (double)x1 + (double)j * char_full_w;
            int32_t sx = (int32_t)offset;
            int32_t ex = (int32_t)(offset + char_w);
            int32_t* r = out_records + n_out * 5;
            r[0] = y1;
            r[1] = y2;
            r[2] = sx;
            r[3] = ex;
            r[4] = char_ids[t0 + j];
            out_line_idx[n_out] = (int32_t)(li + 1);
            out_char_pos[n_out] = j + 1;
            ++n_out;
        }
    }
    return n_out;
}

/* Word-grid char records (entry-A path, data_generator_funsd_bert.py:164-173):
 * x-unit = min_scale, per-char width = max((int)(nw / len), 1).
 * word_boxes: [n_words * 4] float64 raw (x, y, w, h).
 * Returns number of records written.
 */
int64_t build_wordgrid_records(
    int64_t n_words,
    const double* word_boxes,
    const int32_t* text_offsets,
    const int32_t* char_ids,
    double min_x, double min_y,
    double min_scale, double min_h,
    int32_t* out_records)
{
    int64_t n_out = 0;
    for (int64_t wi = 0; wi < n_words; ++wi) {
        const double x = word_boxes[wi * 4 + 0];
        const double y = word_boxes[wi * 4 + 1];
        const double w = word_boxes[wi * 4 + 2];
        const double h = word_boxes[wi * 4 + 3];
        const int32_t t0 = text_offsets[wi];
        const int32_t t1 = text_offsets[wi + 1];
        const int32_t len = t1 - t0;
        if (len <= 0) continue;

        int32_t nx = (int32_t)((x - min_x) / min_scale);
        int32_t ny = (int32_t)((y - min_y) / min_h);
        int32_t nw = (int32_t)(w / min_scale);
        if (nw < 1) nw = 1;
        int32_t nh = (int32_t)(h / min_h);
        if (nh < 1) nh = 1;
        int32_t pcw = nw / len;
        if (pcw < 1) pcw = 1;

        for (int32_t j = 0; j < len; ++j) {
            int32_t* r = out_records + n_out * 5;
            r[0] = ny;
            r[1] = ny + nh;
            r[2] = nx + pcw * j;
            r[3] = nx + pcw * (j + 1);
            r[4] = char_ids[t0 + j];
            ++n_out;
        }
    }
    return n_out;
}
