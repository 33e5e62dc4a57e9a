"""Single-page web console (role of ``app/static/index.html``):
API-key entry persisted in localStorage, PDF upload, YouTube enqueue with 4s
job polling, and chat with inline citations. Original implementation —
plain fetch() against the same endpoints the reference console calls
(``index.html:285,316,354,392``)."""

CONSOLE_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>Multimodal RAG (PyTorch)</title>
<style>
  :root { color-scheme: light dark; font-family: system-ui, sans-serif; }
  body { max-width: 880px; margin: 2rem auto; padding: 0 1rem; line-height: 1.45; }
  fieldset { border: 1px solid #8884; border-radius: 8px; margin-bottom: 1rem; }
  input, button, textarea { font: inherit; padding: .4rem .6rem; }
  input[type=text], input[type=password] { width: 24rem; max-width: 100%; }
  #chatlog { border: 1px solid #8884; border-radius: 8px; padding: .8rem;
             min-height: 8rem; white-space: pre-wrap; }
  .cite { color: #888; font-size: .85em; }
  .bar { background: #8883; border-radius: 4px; height: 8px; overflow: hidden; }
  .bar > div { background: #4a8; height: 100%; width: 0; transition: width .5s; }
  .err { color: #c44; }
</style>
</head>
<body>
<h1>Multimodal RAG <small>(PyTorch port)</small></h1>

<fieldset><legend>API key</legend>
  <input id="apikey" type="password" placeholder="X-API-Key">
  <button onclick="saveKey()">Save</button> <span id="keystate"></span>
</fieldset>

<fieldset><legend>Upload PDF</legend>
  <input id="pdffile" type="file" accept=".pdf">
  <button onclick="uploadPdf()">Ingest</button>
  <div id="pdfstate"></div>
</fieldset>

<fieldset><legend>Ingest YouTube video</legend>
  <input id="yturl" type="text" placeholder="https://www.youtube.com/watch?v=...">
  <button onclick="enqueueYt()">Enqueue</button>
  <div class="bar"><div id="ytbar"></div></div>
  <div id="ytstate"></div>
</fieldset>

<fieldset><legend>Chat</legend>
  <input id="query" type="text" placeholder="Ask about your documents"
         onkeydown="if(event.key==='Enter')chat()">
  <button onclick="chat()">Ask</button>
  <div id="chatlog"></div>
</fieldset>

<fieldset><legend>Videos</legend>
  <button onclick="listVideos()">Refresh</button>
  <div id="videos"></div>
</fieldset>

<script>
const $ = id => document.getElementById(id);
const esc = (t) => String(t ?? '').replace(/[&<>"']/g,
  ch => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[ch]));
const key = () => localStorage.getItem('apikey') || '';
function saveKey() {
  localStorage.setItem('apikey', $('apikey').value);
  $('keystate').textContent = 'saved';
}
$('apikey').value = key();
async function api(path, opts = {}) {
  opts.headers = Object.assign({'X-API-Key': key()}, opts.headers || {});
  const res = await fetch(path, opts);
  const body = await res.json().catch(() => ({}));
  if (!res.ok) throw new Error(body.detail || res.status);
  return body;
}
async function uploadPdf() {
  const f = $('pdffile').files[0];
  if (!f) return;
  $('pdfstate').textContent = 'uploading…';
  const fd = new FormData();
  fd.append('file', f);
  try {
    const out = await api('/process-pdf/', {method: 'POST', body: fd});
    $('pdfstate').textContent =
      `ready: ${out.text_nodes} text + ${out.image_nodes} image nodes`;
  } catch (e) { $('pdfstate').innerHTML = `<span class=err>${esc(e.message)}</span>`; }
}
let pollTimer = null;
async function enqueueYt() {
  const url = $('yturl').value.trim();
  if (!url) return;
  try {
    const out = await api('/ingest/youtube', {
      method: 'POST', headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({url})});
    $('ytstate').textContent = `job ${out.job_id} queued`;
    clearInterval(pollTimer);
    pollTimer = setInterval(() => poll(out.job_id), 4000);
  } catch (e) { $('ytstate').innerHTML = `<span class=err>${esc(e.message)}</span>`; }
}
async function poll(jobId) {
  try {
    const st = await api(`/yt_status/${jobId}`);
    $('ytbar').style.width = (st.pct || 0) + '%';
    $('ytstate').textContent =
      `${st.state} — ${st.meta && st.meta.stage || ''} (${st.pct || 0}%)`;
    if (st.state === 'SUCCESS' || st.state === 'FAILURE') {
      clearInterval(pollTimer);
      if (st.state === 'SUCCESS') listVideos();
      if (st.state === 'FAILURE')
        $('ytstate').innerHTML = `<span class=err>${esc(st.meta.error || 'failed')}</span>`;
    }
  } catch (e) { clearInterval(pollTimer); }
}
async function chat() {
  const q = $('query').value.trim();
  if (!q) return;
  $('chatlog').textContent = 'thinking…';
  try {
    const out = await api('/chat_pro', {
      method: 'POST', headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({query: q})});
    const cites = (out.citation_tokens || []).map(c => c.token).join(' ');
    // esc(): answers embed indexed document text; titles come from YouTube
    // metadata — untrusted content must never reach innerHTML unescaped
    $('chatlog').innerHTML =
      `<b>${out.abstained ? '(abstained)' : ''}</b> ${esc(out.answer)}` +
      `<div class=cite>${esc(cites)}</div>`;
  } catch (e) { $('chatlog').innerHTML = `<span class=err>${esc(e.message)}</span>`; }
}
async function listVideos() {
  try {
    const out = await api('/videos/');
    $('videos').innerHTML = (out.videos || []).map(v =>
      `<div>${esc(v.video_id)} — ${esc(v.title || '')}</div>`).join('') || '(none)';
  } catch (e) { $('videos').innerHTML = `<span class=err>${esc(e.message)}</span>`; }
}
</script>
</body>
</html>
"""
